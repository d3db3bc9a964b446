"""Mean host milliseconds from a batch being formed to the executor's
return, over the batches answered in the window (the batcher's observer
records, ``execute_s``): the enqueue of the batch's launches and fallbacks,
and any synchronisation the path makes.  Not device time."""


def read(run):
    ex = {r["batch_id"]: r["execute_s"] for r in run.records}
    return 1e3 * sum(ex.values()) / len(ex) if ex else None
