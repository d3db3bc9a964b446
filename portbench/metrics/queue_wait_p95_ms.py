"""95th percentile (nearest rank) of the time from submit to the batch
being formed, over every request answered in the window (the batcher's
observer records, ``queue_wait_s``)."""
import math


def read(run):
    waits = sorted(r["queue_wait_s"] for r in run.records)
    if not waits:
        return None
    return 1e3 * waits[max(0, math.ceil(0.95 * len(waits)) - 1)]
