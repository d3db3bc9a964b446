"""Kernel launches of the fused path (``ops.LAUNCHES``: chain and
horizontal) plus fallback items run (``executor.fallback_launches``), per
executor call, over the calls the window made (program counters)."""


def read(run):
    c = run.counts
    if not c.get("calls"):
        return None
    return (c["chain"] + c["horizontal"] + c["fallbacks"]) / c["calls"]
