"""The yardstick's counts of work, against counts worked out by hand."""
import math
from types import SimpleNamespace

import pytest

from portbench import work
from portbench.reference import googlenet, model, vgg16

SHAPES = {"x": (8, 8, 4), "side": (4, 4, 8)}
WEIGHTS = {"c1": (3, 3, 4, 16), "c2": (1, 1, 16, 8), "a": (1, 1, 4, 16),
           "b": (1, 1, 4, 8)}


def test_model_operations_of_the_two_configurations():
    # VGG16-224: 13 convs and 3 fcs; GoogLeNet-224: 57 convs and 1 fc
    assert model.macs(vgg16.layers(224, 1000)) == 15_470_264_320
    assert model.macs(googlenet.layers(224, 1000)) == 1_582_671_872
    assert work.model_ops(vgg16.layers(224, 1000)) == 2 * 15_470_264_320
    # VGG16's first two convs and fc8, by hand
    shp = model.shapes(vgg16.layers(224, 1000))
    assert shp["conv1"] == (224, 224, 64) and shp["pool13"] == (7, 7, 512)
    assert sum(1 for _, op, _, _ in googlenet.layers(224, 1000)
               if op == "conv") == 57


def test_chain_work_by_hand():
    # conv 3x3 (4 -> 16) on 8x8, max pool 2x2/2 to 4x4, conv 1x1 (16 -> 8),
    # eltwise with a 4x4x8 side; two images
    launch = SimpleNamespace(
        kind="chain", in_name="x", sides=("side",), fc_reshape=False,
        out_hw=(4, 4),
        stages=(("conv", "c1", 3, 3, 1, 1, 1, 1, 1, 1, 0, True, 8, 8),
                ("pool", "p", "max", 2, 2, 2, 2, 0, 0, 4, 4),
                ("conv", "c2", 1, 1, 1, 1, 0, 0, 1, 1, 0, False, 4, 4),
                ("elt", "e", "side", 0, False, 4, 4)))
    nbytes, macs = work.chain_work(launch, SHAPES.__getitem__,
                                   WEIGHTS.__getitem__, 2)
    # input 2*8*8*4, weights 576 + 128, biases 4*(16 + 8), side 2*4*4*8,
    # output 2*4*4*8
    assert nbytes == 512 + 704 + 96 + 256 + 256
    assert macs == 2 * 8 * 8 * 576 + 2 * 4 * 4 * 128


def test_horizontal_work_by_hand():
    launch = SimpleNamespace(kind="horizontal", in_name="x", out_hw=(8, 8),
                             members=(("a", 16, 3, True), ("b", 8, 2, True)))
    nbytes, macs = work.horizontal_work(launch, SHAPES.__getitem__,
                                        WEIGHTS.__getitem__, 2)
    # input 512, weights 64 + 32, bias, shift and ReLU vectors 3*4*24,
    # output 2*8*8*24
    assert nbytes == 512 + 96 + 288 + 3072
    assert macs == 2 * 64 * 96


def test_least_seconds_takes_the_longer_bound():
    peak = {"int8_ops_per_s": 1e12, "bytes_per_s": 1e9}
    assert work.least_seconds(10**9, 10, peak) == 1.0
    assert work.least_seconds(1, 10**12, peak) == 2.0


@pytest.mark.parametrize("name,layers", [("vgg16", vgg16.layers),
                                         ("googlenet", googlenet.layers)])
def test_launch_work_of_the_plans_adds_up_to_the_model(name, layers):
    """Over the ZU2 plan the port lowers at 224, the launches' MACs are the
    model's: every conv and fc runs in exactly one launch."""
    from repro_torch.cnn import build
    from repro_torch.core import lower, pathsearch
    from repro_torch.hw import ZU2

    g = build(name, img=224, num_classes=1000)
    prog = lower.lower_strategy(g, pathsearch.search(g, ZU2), None)
    lays = layers(224, 1000)
    wshape = {n: w for n, w, _ in model.param_shapes(lays)}.__getitem__
    shape = lambda n: tuple(g.shape(n)[1:])  # noqa: E731
    total = 0
    for lc in prog.launches():
        fn = work.chain_work if lc.kind == "chain" else work.horizontal_work
        nbytes, macs = fn(lc, shape, wshape, 1)
        assert nbytes > 0
        total += macs
    assert total == model.macs(lays)
    weights = sum(math.prod(w) for _, w, _ in model.param_shapes(lays))
    assert weights == {"vgg16": 138_344_128, "googlenet": 6_990_272}[name]
