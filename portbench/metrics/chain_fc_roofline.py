"""Share of their roofline the chain launches with a 1x1 output (VGG16's
fc6, fc7 and fc8) reach over the traced calls: the least time of their
work (``work.chain_work`` at each span's batch size, ``work.least_seconds``)
over the device time of their executor-item spans (``TRACER``'s ``device``
track, CUDA events around each item).  Nothing where the count of those
spans is not the launches' count times the traced calls', as in a program
without item spans, or where the card has no peak."""
from portbench import work


def fc(launch) -> bool:
    return tuple(launch.out_hw) == (1, 1)


def share(run, pick):
    """The roofline share of the chain launches ``pick`` keeps."""
    from repro_torch.obs.trace import TRACER

    launches = {lc.out_name: lc for lc in run.launches
                if lc.kind == "chain" and pick(lc)}
    if not (launches and run.traced_batches and run.peak):
        return None
    spans = [s for s in TRACER.records() if s.track == "device"
             and s.args.get("kind") == "chain"
             and s.args.get("out") in launches]
    if len(spans) != len(launches) * len(run.traced_batches):
        return None
    least = sum(work.least_seconds(*work.chain_work(
        launches[s.args["out"]], run.shape, run.wshape, s.args["batch"]),
        run.peak) for s in spans)
    return 100 * least / sum(s.duration for s in spans)


def read(run):
    return share(run, fc)
