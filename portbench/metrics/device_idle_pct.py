"""Share of the traced window in which no kernel, copy or set ran on the
device: 100 minus the union of their intervals over the window."""


def read(run):
    if not run.trace:
        return None
    return 100 * (1 - run.trace["busy_s"] / run.trace["window_s"])
