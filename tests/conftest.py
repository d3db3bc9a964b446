import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_toy_resnet_graph(size=16, c=8):
    """Small branchy graph exercising conv/pool/eltwise/fc + frontend passes."""
    from repro.core import frontend
    from repro.core.xgraph import XGraph

    g = XGraph("toy")
    g.input("data", (1, size, size, c))
    g.add("conv", "c1", ("data",), oc=16, kernel=(3, 3), stride=(1, 1), pad="same")
    g.add("relu", "r1", ("c1",))
    g.add("conv", "c2a", ("r1",), oc=16, kernel=(3, 3), pad="same")
    g.add("relu", "r2a", ("c2a",))
    g.add("conv", "c2b", ("r2a",), oc=16, kernel=(3, 3), pad="same")
    g.add("conv", "c2s", ("r1",), oc=16, kernel=(1, 1), pad="same")
    g.add("eltwise_add", "add1", ("c2b", "c2s"))
    g.add("relu", "r3", ("add1",))
    g.add("conv", "c3", ("r3",), oc=16, kernel=(3, 3), pad="valid")
    g.add("maxpool", "p1", ("c3",), kernel=(2, 2), stride=(2, 2))
    g.add("fc", "fc1", ("p1",), oc=10)
    return frontend.lower(g)


def toy_params(g, seed=0):
    from repro.cnn import init_params

    return init_params(g, seed=seed)
