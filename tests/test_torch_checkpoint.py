"""The port's ``CheckpointStore`` after the reference's own checks
(``test_train_infra.py``: roundtrip, async + gc, crash safety, the retry
loop; ``test_checkpoint_async.py``: concurrent waits, a sync save behind
an in-flight async one, back-to-back async writes), and across packages:
a checkpoint written by the JAX package restores in the port and one
written by the port restores in the JAX package, leaf for leaf, bf16
included (the format is shared)."""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro_torch.checkpoint.store as store_mod
from repro import configs as jconfigs
from repro.checkpoint.store import CheckpointStore as JStore
from repro.launch import train as jtrain
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.carry import train_state_from_reference
from repro_torch.core.tree import leaves
from repro_torch.distributed.health import RetryPolicy, run_with_retries
from repro_torch.launch import train as ttrain

CFG = dataclasses.replace(tconfigs.get("smollm-360m").smoke(), n_layers=2,
                          dtype="bfloat16")
STATE = {"w": torch.arange(16, dtype=torch.float32),
         "b": torch.ones(4, dtype=torch.float32)}


def _state():
    return ttrain.init_state(CFG, device="cpu")


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    store = CheckpointStore(str(tmp_path))
    store.save(state, step=7)
    restored, step = store.restore_latest(state)
    assert step == 7 and _equal(state, restored)
    assert leaves(restored)[0].device.type == "cpu"


def test_restore_onto_a_meta_template(tmp_path):
    """A template of ``meta`` tensors (``abstract_state``) shapes the state;
    the device is the caller's."""
    state = _state()
    store = CheckpointStore(str(tmp_path))
    store.save(state, step=3)
    restored, step = store.restore(3, ttrain.abstract_state(CFG), "cpu")
    assert step == 3 and _equal(state, restored)


def test_checkpoint_async_and_gc(tmp_path):
    state = _state()
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        store.save(state, step=s, async_write=True)
        store.wait()
    assert store.steps() == [3, 4]


def test_checkpoint_crash_safety(tmp_path):
    """A checkpoint without COMMITTED is invisible."""
    state = _state()
    store = CheckpointStore(str(tmp_path))
    p = store.save(state, step=1)
    os.remove(os.path.join(p, "COMMITTED"))
    assert store.steps() == []
    assert store.restore_latest(state) is None


def test_async_save_snapshots_before_returning(tmp_path):
    """The leaves are copied before ``save`` returns: a later in-place
    change is not what gets written."""
    state = {"w": torch.zeros(8)}
    store = CheckpointStore(str(tmp_path))
    store.save(state, step=1, async_write=True)
    state["w"].add_(1.0)
    store.wait()
    restored, _ = store.restore(1, state)
    assert not restored["w"].any()


def test_wait_is_idempotent_and_concurrent_safe(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(STATE, step=1, async_write=True)
    errors = []

    def waiter():
        try:
            store.wait()
        except Exception as e:          # pragma: no cover - the regression
            errors.append(e)

    threads = [threading.Thread(target=waiter) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors
    store.wait()
    store.wait()
    assert store.steps() == [1]


def test_sync_save_and_gc_serialized_behind_inflight_async_write(
        tmp_path, monkeypatch):
    store = CheckpointStore(str(tmp_path), keep=1)
    gate = threading.Event()
    entered = threading.Event()
    orig = store_mod._encode
    calls = {"n": 0}

    def gated_encode(arr):
        calls["n"] += 1
        if calls["n"] == 1:
            entered.set()
            assert gate.wait(timeout=10)
        return orig(arr)

    monkeypatch.setattr(store_mod, "_encode", gated_encode)
    store.save(STATE, step=1, async_write=True)
    assert entered.wait(timeout=10)
    done = threading.Event()

    def sync_save():
        store.save(STATE, step=2)
        done.set()

    t = threading.Thread(target=sync_save)
    t.start()
    assert not done.wait(timeout=0.3)
    gate.set()
    assert done.wait(timeout=10)
    t.join(timeout=10)
    assert not t.is_alive()
    store.wait()
    assert store.steps() == [2]
    restored, step = store.restore_latest(STATE)
    assert step == 2 and torch.equal(restored["w"], STATE["w"])


def test_async_writes_back_to_back_commit_all(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=3)
    for s in (1, 2, 3, 4):
        store.save(STATE, step=s, async_write=True)
    store.wait()
    assert store.steps() == [2, 3, 4]


# -------------------------------------------------------------- cross-package
def _jax_state():
    jcfg = dataclasses.replace(jconfigs.get("smollm-360m").smoke(),
                               n_layers=2, dtype="bfloat16")
    return jtrain.init_state(jcfg)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    js = _jax_state()
    JStore(str(tmp_path)).save(js, step=5)
    template = ttrain.abstract_state(CFG)
    restored, step = CheckpointStore(str(tmp_path)).restore_latest(
        template, "cpu")
    assert step == 5
    want = train_state_from_reference(jax.tree.map(np.asarray, js), "cpu")
    assert _equal(want, restored)
    assert restored["params"]["embed"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32


def test_port_checkpoint_restores_in_jax(tmp_path):
    js = _jax_state()
    ts = train_state_from_reference(jax.tree.map(np.asarray, js), "cpu")
    ts["params"]["embed"] = ts["params"]["embed"] + 1     # not init values
    ts["opt"]["step"] = torch.tensor(9, dtype=torch.int32)
    CheckpointStore(str(tmp_path)).save(ts, step=9)
    restored, step = JStore(str(tmp_path)).restore_latest(
        jax.eval_shape(lambda: js))
    assert step == 9
    got = jax.tree.leaves(restored)
    assert len(got) == len(leaves(ts))
    for a, b in zip(got, leaves(ts)):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        if b.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16),
                b.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert restored["params"]["embed"].dtype == jnp.bfloat16


# ------------------------------------------------------------- retry loop
def test_retry_loop_resumes_from_checkpoint(tmp_path):
    """``run_with_retries`` (copied from the reference) on the port's store:
    its restores place the state on the template's device."""
    store = CheckpointStore(str(tmp_path))
    state = _state()
    calls = {"n": 0}

    def run(st, start):
        calls["n"] += 1
        if calls["n"] == 1:
            store.save(st, step=13)
            raise RuntimeError("simulated host failure")
        return st, start

    got, start = run_with_retries(lambda: state, run, store,
                                  RetryPolicy(max_restarts=3), state)
    assert start == 13 and calls["n"] == 2 and _equal(got, state)
