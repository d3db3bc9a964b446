"""Share of its roofline the chain kernel reaches over the traced calls:
the least time of their chain launches' work (``work.chain_work`` from each
launch's descriptor at the call's batch size, ``work.least_seconds``) over
the device seconds of the kernels named below in the trace.  Nothing where
the trace's count of those kernels is not the calls' count of chain
launches."""
from portbench import work

KERNELS = ("chain_kernel",)


def read(run):
    launches = [lc for lc in run.launches if lc.kind == "chain"]
    if not (launches and run.traced_batches and run.peak):
        return None
    events = sum(run.trace["kernel_events"].get(k, 0) for k in KERNELS)
    if events != len(launches) * len(run.traced_batches):
        return None
    least = sum(work.least_seconds(*work.chain_work(lc, run.shape, run.wshape,
                                                    b), run.peak)
                for b in run.traced_batches for lc in launches)
    return 100 * least / sum(run.trace["kernel_s"][k] for k in KERNELS)
