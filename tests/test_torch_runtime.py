"""repro_torch.runtime on the CPU: Session.run, run_batch and a Server
answering requests, bit-equal to the reference's ref executor (the float
softmax output within atol 1e-6, as in test_torch_executor)."""
import numpy as np
import pytest
import torch

from repro.core import executor as ref_executor
from repro_torch.core import quantize
from repro_torch.hw import ZU2
from repro_torch.obs.trace import TRACER
from repro_torch.runtime import BatcherClosed, Server, Session
from torch_common import port_model, reference_model, strategy

MODEL, IMG = "googlenet", 64


@pytest.fixture(scope="module")
def served():
    g_ref, _, _, qm_ref, _ = reference_model(MODEL, IMG)
    g, qm, _ = port_model(MODEL, IMG)
    rng = np.random.default_rng(11)
    imgs = [quantize.quantize_to(rng.standard_normal(g.shape("data")[1:]),
                                 qm.f_a["data"]) for _ in range(6)]
    ref = ref_executor.Int8Executor(g_ref, qm_ref, strategy=None,
                                    backend="ref")
    want = [ref(x[None]) for x in imgs]
    sess = Session(g, strategy("repro_torch", g), ZU2, qm, device="cpu")
    return sess, imgs, want


def _close(got, want):
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_session_run_matches_reference(served):
    sess, imgs, want = served
    before = sess.stats()["images_served"]
    for x, w in zip(imgs[:2], want):
        _close(sess.run(x), w)                 # (H, W, C)
    _close(sess.run(imgs[2][None]), want[2])   # (1, H, W, C)
    st = sess.stats()
    assert st["images_served"] == before + 3
    assert st["device"] == "cpu" and st["backend"] == "fused"
    assert st["n_launches"] == 51 and st["fused_coverage"] > 0.97


def test_run_batch_pads_and_matches_reference(served):
    sess, imgs, want = served
    TRACER.enable()
    try:
        outs = sess.run_batch(imgs[:3], pad_to=4)
        names = {s.name for s in TRACER.records()}
    finally:
        TRACER.disable()
        TRACER.clear()
    assert {"pad", "launch"} <= names
    assert len(outs) == 3
    for o, w in zip(outs, want):
        _close(o, w)


def test_server_answers_match_session_and_reference(served):
    sess, imgs, want = served
    with Server(sess, max_batch=4, max_latency_s=0.05) as server:
        futs = [server.submit(x) for x in imgs]
        answers = [f.result(timeout=120) for f in futs]
        stats = server.stats()
    with pytest.raises(BatcherClosed):
        server.submit(imgs[0])
    assert stats["n_served"] == 6 and stats["allowed_sizes"] == [1, 2, 4]
    assert sum(k * v for k, v in stats["batch_histogram"].items()) == 6
    for a, x, w in zip(answers, imgs, want):
        _close(a, w)
        single = sess.run(x)
        assert torch.equal(a["prob"], single["prob"])


def test_launch_hook_sees_every_launch(served):
    sess, imgs, _ = served
    seen = []
    sess.set_launch_hook(lambda x: seen.append(tuple(x.shape)))
    try:
        sess.run(imgs[0])
        sess.run_batch(imgs[:2])
    finally:
        sess.set_launch_hook(None)
    assert seen == [(1, IMG, IMG, 3), (2, IMG, IMG, 3)]

    def boom(x):
        raise RuntimeError("injected")
    sess.set_launch_hook(boom)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            sess.run(imgs[0])
    finally:
        sess.set_launch_hook(None)


def test_slo_cap_shrinks_under_a_tiny_target(served):
    sess, imgs, _ = served
    server = Server(sess, max_batch=4, max_latency_s=0.0, warmup=False,
                    target_p99_ms=1e-6)
    try:
        for _ in range(3):
            for f in [server.submit(x) for x in imgs[:4]]:
                f.result(timeout=120)
    finally:
        server.close()
    st = server.stats()
    assert st["slo_shrinks"] >= 1 and st["effective_max_batch"] < 4
    assert st["slo_shrinks"] == (st["slo_shrinks_queue_bound"]
                                 + st["slo_shrinks_launch_bound"])


def test_ref_backend_session_matches(served):
    _, imgs, want = served
    g, qm, _ = port_model(MODEL, IMG)
    sess = Session(g, strategy("repro_torch", g), ZU2, qm, backend="ref",
                   device="cpu")
    _close(sess.run(imgs[0]), want[0])
