"""Mean images per batch the batcher formed, over the batches answered in
the window (the batcher's observer records)."""


def read(run):
    sizes = {r["batch_id"]: r["batch_size"] for r in run.records}
    return sum(sizes.values()) / len(sizes) if sizes else None
