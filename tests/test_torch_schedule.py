"""repro_torch.runtime.schedule (cross-request pipelining of the addressed
ISA stream) and ``Session.pipeline_report`` against the reference on
artifacts both packages compile from the same graph and quantized model:
the pipelined stream, the report and ``choose_ddr_slots``, with and
without a device profile, field for field."""
import dataclasses

import pytest

import repro.asm as ref_asm
from repro.runtime import Session as RefSession
from repro.runtime import schedule as ref_schedule
from repro.tune import DeviceProfile as RefDeviceProfile
from repro_torch import asm
from repro_torch.hw import ZU2
from repro_torch.runtime import Session, schedule
from repro_torch.tune import DeviceProfile
from repro_torch.tune.profile import COEF_NAMES
from torch_common import port_model, reference_model, strategy

MODELS = [("toy", 16), ("googlenet", 32)]
FIELDS = ("n_requests", "total_cycles", "single_request_cycles",
          "busy_cycles", "request_windows", "ddr_slots", "n_instructions",
          "pin_input", "n_preload_guards", "ddr_slots_source",
          "engine_timeline")


def _both(model, img, pin_input=False):
    from repro.hw import ZU2 as REF_ZU2
    g_ref, _, _, qm_ref, _ = reference_model(model, img)
    g, qm, _ = port_model(model, img)
    want = ref_asm.compile_strategy(g_ref, strategy("repro", g_ref), REF_ZU2,
                                    qm=qm_ref, pin_input=pin_input)
    got = asm.compile_strategy(g, strategy("repro_torch", g), ZU2, qm=qm,
                               pin_input=pin_input)
    assert [dataclasses.astuple(i) for i in got.instrs] == \
        [dataclasses.astuple(i) for i in want.instrs]
    return got, want


def _profiles(bw):
    coef = [0.0] * len(COEF_NAMES)
    coef[COEF_NAMES.index("rd")] = 1.0 / bw
    kw = dict(name=f"bw{bw:g}", device="zu2", backend="fused",
              jax_version="t", features="kernel", combine="sum",
              coef=tuple(coef), deviation=0.0, n_samples=3)
    return DeviceProfile(**kw), RefDeviceProfile(**kw)


def _same_report(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if f == "engine_timeline":
            a = {e: [tuple(w) for w in v] for e, v in a.items()}
            b = {e: [tuple(w) for w in v] for e, v in b.items()}
        assert a == b, f
    assert got.modeled_speedup == want.modeled_speedup
    assert got.bottleneck == want.bottleneck
    assert got.utilization() == want.utilization()


@pytest.mark.parametrize("pin_input", [False, True])
@pytest.mark.parametrize("model,img", MODELS)
def test_pipeline_stream_equals_reference(model, img, pin_input):
    got, want = _both(model, img, pin_input)
    a = schedule.pipeline_stream(got, 3)
    b = ref_schedule.pipeline_stream(want, 3)
    assert [dataclasses.astuple(i) for i in a] == \
        [dataclasses.astuple(i) for i in b]


@pytest.mark.parametrize("ddr_slots", [2, 3, None])
@pytest.mark.parametrize("model,img", MODELS)
def test_pipeline_report_equals_reference(model, img, ddr_slots):
    got, want = _both(model, img)
    _same_report(schedule.pipeline_report(got, 4, ddr_slots=ddr_slots),
                 ref_schedule.pipeline_report(want, 4, ddr_slots=ddr_slots))


@pytest.mark.parametrize("scale", [1e3, 1e-3])
@pytest.mark.parametrize("model,img", MODELS)
def test_ddr_slots_under_a_profile_equal_reference(model, img, scale):
    got, want = _both(model, img)
    p, p_ref = _profiles(ZU2.dram_bw_bytes_per_s * scale)
    assert p.hash() == p_ref.hash()
    assert schedule.choose_ddr_slots(got, p) == \
        ref_schedule.choose_ddr_slots(want, p_ref)
    assert schedule.choose_ddr_slots(got) == \
        ref_schedule.choose_ddr_slots(want)
    rep = schedule.pipeline_report(got, 4, ddr_slots=None, profile=p)
    assert rep.ddr_slots_source == "profile"
    _same_report(rep, ref_schedule.pipeline_report(want, 4, ddr_slots=None,
                                                   profile=p_ref))


def test_slow_profile_deepens_ddr_slots():
    got, _ = _both("toy", 16)
    slow, _ = _profiles(ZU2.dram_bw_bytes_per_s / 1e3)
    fast, _ = _profiles(ZU2.dram_bw_bytes_per_s * 1e3)
    assert schedule.choose_ddr_slots(got, fast) == 2
    assert schedule.choose_ddr_slots(got, slow) > 2
    with pytest.raises(ValueError):
        schedule.pipeline_stream(got, 0)


@pytest.mark.parametrize("model,img", MODELS)
def test_session_pipeline_report_equals_reference(model, img):
    from repro.hw import ZU2 as REF_ZU2
    g_ref, _, _, qm_ref, _ = reference_model(model, img)
    g, qm, _ = port_model(model, img)
    p, p_ref = _profiles(ZU2.dram_bw_bytes_per_s / 1e3)
    sess = Session(g, strategy("repro_torch", g), ZU2, qm, device="cpu",
                   cache=asm.PlanCache(), profile=p)
    ref = RefSession(g_ref, strategy("repro", g_ref), REF_ZU2, qm_ref,
                     cache=ref_asm.PlanCache(), profile=p_ref)
    assert sess.artifact.profile_hash == ref.artifact.profile_hash == p.hash()
    got = sess.pipeline_report(4, ddr_slots=None)
    assert got.ddr_slots_source == "profile" and got.ddr_slots > 2
    _same_report(got, ref.pipeline_report(4, ddr_slots=None))
    _same_report(sess.pipeline_report(2), ref.pipeline_report(2))
    assert sess.stats()["session_profile_hash"] == p.hash()

