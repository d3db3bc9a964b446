"""Mixtral (``moe``), Qwen2-VL (``vlm``) and Seamless (``audio``) under a
mesh, against the JAX package, at smoke size in fp32 on spawned gloo CPU
ranks (``tests/torch_ranks.py``).

For each family: the TP = 2 prefill on a (1, 2) mesh (Qwen2-VL with patch
embeddings and M-RoPE, Seamless with encoder frames) within 1e-4 of the
unsharded port and of the JAX package's prefill, the serve loop's tokens
on a ``cache_specs``-placed cache equal to the unsharded loop's, and one
(2, 2) ``grad_sync="late"`` step within the reference's tolerances of the
unsharded step over the same microbatches, every gradient leaf within
1e-4 of its largest value.  Each family's two rank groups run once (module-scoped
fixtures), beside the reference.
"""
import pytest

from torch_common import (check_family_serve, check_family_train,
                          family_mesh_run)


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    return family_mesh_run("mixtral-8x7b", tmp_path_factory.mktemp("moe"))


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    return family_mesh_run("qwen2-vl-7b", tmp_path_factory.mktemp("vlm"))


@pytest.fixture(scope="module")
def seamless(tmp_path_factory):
    return family_mesh_run("seamless-m4t-large-v2",
                           tmp_path_factory.mktemp("audio"))


def test_mixtral_tp2_prefill_and_serve_loop(mixtral):
    check_family_serve(mixtral)


def test_mixtral_late_step_on_2x2(mixtral):
    """The one-hot routing gate and the load-balancing loss on DTensor
    indices."""
    check_family_train(mixtral)


def test_qwen2_vl_tp2_prefill_and_serve_loop(qwen):
    check_family_serve(qwen)


def test_qwen2_vl_flash_on_each_ranks_local_heads(qwen):
    """Flash (its plain version here) runs once a layer on each rank's
    q and kv heads."""
    cfg = qwen["cfg"]
    (q, k), = qwen["serve"]["seen"]["flash"]
    assert (q[2], k[2]) == (cfg.n_heads // 2, cfg.n_kv_heads // 2)


def test_qwen2_vl_late_step_on_2x2(qwen):
    check_family_train(qwen)


def test_seamless_tp2_prefill_and_serve_loop(seamless):
    check_family_serve(seamless)


def test_seamless_late_step_on_2x2(seamless):
    check_family_train(seamless)
