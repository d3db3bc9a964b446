"""95th percentile (nearest rank) of the program's own latency, submit to
the batch's completion on the device (the batcher's observer records,
``latency_s``), over every request answered in the window.  It leaves out
the client's copy of the answer to the host, which ``latency_p95_ms``
holds.  Nothing where the records carry no completion (``done_s``): their
latency then ends at the batch's enqueue."""
import math


def read(run):
    if not run.records or any("done_s" not in r for r in run.records):
        return None
    lat = sorted(r["latency_s"] for r in run.records)
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
