"""repro_torch.core.executor against repro.core.executor on the CPU.

Float: ``run_float`` equals the reference within rtol 1e-4 / atol 1e-5 of
the activation scale (float32 sums taken in another order).  Calibration:
identical fractions.  Int8: the port's ref and fused executors are
bit-equal to the reference's ref executor, with the reference's quantized
model carried across; the float softmax output is held to atol 1e-6.
"""
from functools import partial

import numpy as np
import pytest

from repro.core import executor as ref_executor
from repro_torch.core import executor, quantize, validate
from repro_torch.core.carry import params_from_reference, qm_from_reference
from torch_common import (build_graph, port_model, reference_model,
                          strategy)

run_float_cpu = partial(executor.run_float, device="cpu")


@pytest.mark.parametrize("model,img", [("toy", 16), ("googlenet", 64)])
def test_run_float_matches_reference(model, img):
    g_ref, params, x, _, _ = reference_model(model, img)
    g = build_graph("repro_torch", model, img)
    want = ref_executor.run_float(g_ref, params, x)
    got = run_float_cpu(g, params_from_reference(params), x)
    assert set(got) == set(want)
    for k in want:
        scale = float(np.max(np.abs(want[k]))) or 1.0
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("model,img", [("toy", 16), ("googlenet", 64)])
def test_calibrate_gives_identical_fractions(model, img):
    g_ref, params, x, qm_ref, _ = reference_model(model, img)
    g = build_graph("repro_torch", model, img)
    qm = quantize.calibrate(g, params_from_reference(params), x,
                            run_float_cpu)
    assert qm.f_a == qm_ref.f_a
    assert qm.f_w == qm_ref.f_w
    for k in qm_ref.weights:
        np.testing.assert_array_equal(qm.weights[k], qm_ref.weights[k])
        np.testing.assert_array_equal(qm.biases[k], qm_ref.biases[k])


def _assert_outputs_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g_, w_ = got[k].numpy(), np.asarray(want[k])
        assert g_.dtype == w_.dtype, (k, g_.dtype, w_.dtype)
        if np.issubdtype(w_.dtype, np.integer):
            np.testing.assert_array_equal(g_, w_, err_msg=k)
        else:
            np.testing.assert_allclose(g_, w_, rtol=0, atol=1e-6, err_msg=k)


CASES = [("toy", 16, "naive"), ("toy", 16, "greedy"), ("toy", 16, "search"),
         ("googlenet", 64, "search"), ("resnet50", 32, "search")]


@pytest.mark.parametrize("model,img,strat", CASES)
def test_int8_executors_match_reference_ref(model, img, strat):
    g_ref, _, _, qm_ref, xq = reference_model(model, img)
    want = ref_executor.Int8Executor(g_ref, qm_ref, strategy=None,
                                     backend="ref")(xq)
    g, qm, _ = port_model(model, img)
    s = strategy("repro_torch", g, strat)
    for backend in ("ref", "fused"):
        got = executor.Int8Executor(g, qm, strategy=s, backend=backend,
                                    device="cpu")(xq)
        _assert_outputs_equal(got, want)


def test_fused_executor_dispatches_program_without_relowering():
    g, qm, xq = port_model("toy", 16)
    from repro_torch.core import lower
    prog = lower.lower_strategy(g, strategy("repro_torch", g), qm)

    class Carrier:
        program = prog

    ex = executor.Int8Executor(g, qm, strategy=Carrier(), backend="fused",
                               device="cpu")
    assert ex.program is prog
    with pytest.raises(ValueError, match="int8"):
        ex(xq.astype(np.float32))
    with pytest.raises(ValueError, match="extents"):
        ex(np.zeros((1, 8, 8, 8), np.int8))
    with pytest.raises(ValueError, match="backend"):
        executor.Int8Executor(g, qm, backend="pallas", device="cpu")


def test_validate_bit_exact_and_coverage_on_cpu():
    g_ref, params, _, _, _ = reference_model("googlenet", 64)
    g, qm, xq = port_model("googlenet", 64)
    s = strategy("repro_torch", g)
    rep = validate.bit_exact(g, qm, xq, s, device="cpu",
                             float_params=params_from_reference(params))
    assert rep.bit_exact and rep.max_abs_diff == 0
    assert all(np.isfinite(v) and v > 0 for v in rep.sqnr_db.values())
    cov = validate.fused_coverage(g, s, qm)
    assert cov.kinds == {"chain": 42, "horizontal": 9}
    assert cov.fallback_reasons == {"folded_concat": 9, "unsupported_op": 1}


def test_qm_carry_round_trips_reference_model():
    _, _, _, qm_ref, _ = reference_model("toy", 16)
    qm = qm_from_reference(qm_ref)
    assert qm.f_a == qm_ref.f_a and qm.f_w == qm_ref.f_w
    for k in qm_ref.weights:
        assert qm.weights[k].dtype == np.int8
        assert qm.biases[k].dtype == np.int32
        np.testing.assert_array_equal(qm.weights[k], qm_ref.weights[k])
