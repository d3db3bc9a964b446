"""VGG16, configuration D of Simonyan & Zisserman (arXiv:1409.1556), Table 1:
thirteen 3x3 convolutions with ReLU (stride 1, padding 1) in five blocks,
each block closed by a 2x2 max pool of stride 2, then fc6 and fc7 of 4,096
with ReLU, fc8 and a softmax.  Names follow the port's graph (convolutions
numbered 1 to 13, a pool named after the convolution before it), because
the benchmark hands both sides one dictionary of weights."""

BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
          (512, 512, 512))


def layers(img: int, num_classes: int, in_channels: int = 3) -> list:
    out = [("data", "input", (), {"shape": (img, img, in_channels)})]
    last, ci = "data", 0
    for block in BLOCKS:
        for oc in block:
            ci += 1
            out.append((f"conv{ci}", "conv", (last,),
                        {"oc": oc, "kernel": (3, 3), "stride": (1, 1),
                         "pad": (1, 1), "relu": True}))
            last = f"conv{ci}"
        out.append((f"pool{ci}", "maxpool", (last,),
                    {"kernel": (2, 2), "stride": (2, 2), "pad": (0, 0)}))
        last = f"pool{ci}"
    for name, oc, relu in (("fc6", 4096, True), ("fc7", 4096, True),
                           ("fc8", num_classes, False)):
        out.append((name, "fc", (last,), {"oc": oc, "relu": relu}))
        last = name
    out.append(("prob", "softmax", (last,), {}))
    return out
