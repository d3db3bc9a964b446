"""Share of its roofline the horizontal kernel reaches over the traced
calls, as ``chain_roofline`` does it for the horizontal launches
(``work.horizontal_work``).  Nothing where the plan has no horizontal
launch."""
from portbench import work

KERNELS = ("horizontal_mma_kernel",)


def read(run):
    launches = [lc for lc in run.launches if lc.kind == "horizontal"]
    if not (launches and run.traced_batches and run.peak):
        return None
    events = sum(run.trace["kernel_events"].get(k, 0) for k in KERNELS)
    if events != len(launches) * len(run.traced_batches):
        return None
    least = sum(work.least_seconds(*work.horizontal_work(lc, run.shape,
                                                         run.wshape, b),
                                   run.peak)
                for b in run.traced_batches for lc in launches)
    return 100 * least / sum(run.trace["kernel_s"][k] for k in KERNELS)
