"""The correctness check fails its control and the faults a served cell can
have, and passes a sound run: on the CPU at a small size, the harness's
whole run with the look for a card skipped."""
import time

import pytest
import torch

from portbench import cells, control, harness

SEED = 2**31 + 23


def _small(config: str):
    cfg = dict(cells.config_file(config), img=32, num_classes=10)
    traffic = dict(cells.traffic("offline-q128"), outstanding=8, max_batch=4,
                   pool=8, warm_seconds=0.2)
    return cfg, traffic


@pytest.mark.parametrize("config", ["vgg16-224.zu2", "googlenet-224.zu2"])
def test_lower_precision_control_fails_the_check(config):
    cfg, traffic = _small(config)
    numbers = control.control_numbers(cfg, traffic, SEED, "cpu")
    assert numbers["prob_gap"] > cfg["check"]["prob_gap"]


def _run(config: str) -> dict:
    cfg, traffic = _small(config)
    cell = f"{config}.offline-q128"
    return harness.run(cfg, traffic,
                       (cells.end_to_end(cell, cells.benchmark()), []), SEED,
                       1.0, False, "cpu", time.monotonic())


def test_sound_run_is_correct():
    out = _run("googlenet-224.zu2")
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert {"images_per_s", "latency_p95_ms", "setup_s"} <= set(out["metrics"])
    assert out["failed"] == 0 and out["attempted"] > 0


def _half_batch_left_out(orig):
    def run_batch(self, xs, pad_to=None):
        half = max(1, len(xs) // 2)
        outs = orig(self, xs[:half], pad_to=pad_to)
        return [outs[i % half] for i in range(len(xs))]
    return run_batch


def _answers_shifted(orig):
    def run_batch(self, xs, pad_to=None):
        outs = orig(self, xs, pad_to=pad_to)
        return outs[1:] + outs[:1]
    return run_batch


def _one_logit_raised(orig):
    def _int8_node(g, node, env, qm, wts):
        if node.op == "softmax":
            x = env[node.inputs[0]].clone()
            x[..., 0] = (x[..., 0].to(torch.int32) + 16).clamp(max=127).to(
                x.dtype)
            env = dict(env, **{node.inputs[0]: x})
        return orig(g, node, env, qm, wts)
    return _int8_node


FAULTS = ["half_batch", "answers_shifted", "answer_altered"]


def _plant(monkeypatch, fault):
    from repro_torch.core import executor
    from repro_torch.runtime.session import Session

    if fault == "answer_altered":
        monkeypatch.setattr(executor, "_int8_node",
                            _one_logit_raised(executor._int8_node))
    else:
        wrap = {"half_batch": _half_batch_left_out,
                "answers_shifted": _answers_shifted}[fault]
        monkeypatch.setattr(Session, "run_batch", wrap(Session.run_batch))


def _incorrect(out):
    assert not out["correct"]
    assert out["checks"]["prob_gap"]["value"] > \
        out["checks"]["prob_gap"]["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_in_the_timed_path_make_the_run_incorrect(monkeypatch, fault):
    _plant(monkeypatch, fault)
    _incorrect(_run("googlenet-224.zu2"))


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_in_the_benchmarked_cell_make_it_incorrect(monkeypatch, fault):
    """The same faults under the configuration of every cell."""
    _plant(monkeypatch, fault)
    for w in cells.benchmark()["workloads"]:
        _incorrect(_run(w["config"]))
