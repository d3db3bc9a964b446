"""GoogLeNet v1 (Szegedy et al., arXiv:1409.4842, Table 1), as the port
builds it: the stem (7x7/2 conv, 3x3/2 max pool, 1x1 and 3x3 convs, 3x3/2
max pool), nine inception modules with their published branch widths, 3x3/2
max pools after 3b and 4e, a global average pool, one fc and a softmax.
Every convolution has ReLU and "same" padding; pools are Caffe's ceil mode.
Not in it, as in the port: the local response normalisations, dropout and
the two auxiliary classifiers (absent at inference).  Names follow the
port's graph, because the benchmark hands both sides one dictionary of
weights."""

# (1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool projection), Table 1
INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def _conv(out, name, bottom, oc, k, stride=1) -> str:
    out.append((name, "conv", (bottom,),
                {"oc": oc, "kernel": (k, k), "stride": (stride, stride),
                 "pad": ((k - 1) // 2, (k - 1) // 2), "relu": True}))
    return name


def _pool(out, name, bottom, stride, pad) -> str:
    out.append((name, "maxpool", (bottom,),
                {"kernel": (3, 3), "stride": (stride, stride),
                 "pad": (pad, pad)}))
    return name


def layers(img: int, num_classes: int, in_channels: int = 3) -> list:
    out = [("data", "input", (), {"shape": (img, img, in_channels)})]
    last = _conv(out, "conv1", "data", 64, 7, stride=2)
    last = _pool(out, "pool1", last, 2, 0)
    last = _conv(out, "conv2r", last, 64, 1)
    last = _conv(out, "conv2", last, 192, 3)
    last = _pool(out, "pool2", last, 2, 0)
    for mod in ("3a", "3b", "pool3", "4a", "4b", "4c", "4d", "4e", "pool4",
                "5a", "5b"):
        if mod.startswith("pool"):
            last = _pool(out, mod, last, 2, 0)
            continue
        c1, r3, c3, r5, c5, pp = INCEPTION[mod]
        m = f"inc{mod}"
        b1 = _conv(out, f"{m}/1x1", last, c1, 1)
        b2 = _conv(out, f"{m}/3x3r", last, r3, 1)
        b2 = _conv(out, f"{m}/3x3", b2, c3, 3)
        b3 = _conv(out, f"{m}/5x5r", last, r5, 1)
        b3 = _conv(out, f"{m}/5x5", b3, c5, 5)
        b4 = _pool(out, f"{m}/pool", last, 1, 1)
        b4 = _conv(out, f"{m}/poolp", b4, pp, 1)
        out.append((f"{m}/out", "concat", (b1, b2, b3, b4), {}))
        last = f"{m}/out"
    out.append(("gap", "gap", (last,), {}))
    out.append(("fc", "fc", ("gap",), {"oc": num_classes, "relu": False}))
    out.append(("prob", "softmax", ("fc",), {}))
    return out
