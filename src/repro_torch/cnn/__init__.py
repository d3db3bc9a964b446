# Copied from src/repro/cnn/__init__.py; imports point at repro_torch.
"""CNN model zoo — the paper's benchmarks as XGraph builders.

All builders return a *lowered* XGraph (front-end passes applied) plus a
float parameter initializer.  Input is ImageNet-style (1, 224, 224, 3) NHWC
unless overridden (tests use smaller resolutions)."""
from repro_torch.cnn.vgg import vgg16
from repro_torch.cnn.resnet import resnet50, resnet152
from repro_torch.cnn.googlenet import googlenet
from repro_torch.cnn.yolo import yolo_lite

REGISTRY = {
    "vgg16": vgg16,
    "resnet50": resnet50,
    "resnet152": resnet152,
    "googlenet": googlenet,
    "yolo_lite": yolo_lite,
}


def build(name: str, **kw):
    return REGISTRY[name](**kw)


def init_params(g, seed: int = 0, scale: float = 0.1):
    """He-ish random float params for every conv/fc node (pretrained weights
    are unavailable offline; throughput and bit-exactness are weight-agnostic,
    documented in EXPERIMENTS.md)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params = {}
    for n in g:
        if n.op in ("conv", "dilated_conv", "deconv"):
            ic = g.shape(n.inputs[0])[3]
            kh, kw = n.attrs["kernel"]
            oc = n.attrs["oc"]
            std = scale / max(1.0, (kh * kw * ic) ** 0.5) * 4
            params[n.name] = {
                "w": rng.standard_normal((kh, kw, ic, oc)).astype("float32") * std,
                "b": rng.standard_normal(oc).astype("float32") * 0.05}
        elif n.op == "depthwise_conv":
            c = g.shape(n.inputs[0])[3]
            kh, kw = n.attrs["kernel"]
            params[n.name] = {
                "w": rng.standard_normal((kh, kw, 1, c)).astype("float32") * scale,
                "b": rng.standard_normal(c).astype("float32") * 0.05}
        elif n.op == "fc":
            ish = g.shape(n.inputs[0])
            d = ish[1] * ish[2] * ish[3]
            oc = n.attrs["oc"]
            params[n.name] = {
                "w": rng.standard_normal((d, oc)).astype("float32") * (scale / d ** 0.5 * 4),
                "b": rng.standard_normal(oc).astype("float32") * 0.05}
    return params
