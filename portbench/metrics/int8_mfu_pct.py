"""The whole model's share of the card's int8 peak: images answered per
second in the window times the model's int8 operations per image (two per
multiply-accumulate of every conv and fc layer, ``work.model_ops``; not
what the kernels issue) over the peak of ``work.PEAKS``."""


def read(run):
    if not run.peak:
        return None
    return 100 * run.images_per_s * run.model_ops / run.peak["int8_ops_per_s"]
