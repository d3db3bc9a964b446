"""The recurrent families under a mesh, against the JAX package: xLSTM
(``ssm``) and Zamba2 (``hybrid``) at smoke size in fp32 on spawned gloo CPU
ranks (``tests/torch_ranks.py``).

For each family: the TP = 2 prefill on a (1, 2) mesh within 1e-4 of the
unsharded port and of the JAX package's prefill, its scan on each rank's
local heads (Zamba2's one-head q and k expanded there with stride 0), the
serve loop's tokens on a ``cache_specs``-placed cache equal to the
unsharded loop's, and one (2, 2) ``grad_sync="late"`` step within the
reference's tolerances of the unsharded step over the same microbatches,
every gradient leaf within 1e-4 of its largest value.  Each family's two rank
groups run once (module-scoped fixtures), beside the reference.
"""
import pytest
import torch

from torch_common import (check_family_serve, check_family_train,
                          family_mesh_run)


@pytest.fixture(scope="module")
def xlstm(tmp_path_factory):
    return family_mesh_run("xlstm-1.3b", tmp_path_factory.mktemp("xlstm"))


@pytest.fixture(scope="module")
def zamba(tmp_path_factory):
    return family_mesh_run("zamba2-1.2b", tmp_path_factory.mktemp("zamba"))


def test_xlstm_tp2_prefill_and_serve_loop(xlstm):
    check_family_serve(xlstm)


def test_xlstm_scan_runs_on_each_ranks_local_heads(xlstm):
    """4 heads, 2 a rank: q, k, v of the plain scan hold the rank's
    heads."""
    cfg = xlstm["cfg"]
    (q, v, _), = xlstm["serve"]["seen"]["scan"]
    assert q[2] == v[2] == cfg.n_heads // 2


def test_xlstm_late_step_on_2x2(xlstm):
    check_family_train(xlstm)


def test_zamba_tp2_prefill_and_serve_loop(zamba):
    check_family_serve(zamba)


def test_zamba_scan_takes_shared_heads_uncopied(zamba):
    """The C and B projections (q, k) reach each rank's scan as one head
    expanded over its local heads, stride 0 on the head dim."""
    cfg = zamba["cfg"]
    (q, v, q_head_stride), = zamba["serve"]["seen"]["scan"]
    assert q[2] == v[2] == cfg.n_heads // 2
    assert q[3] == cfg.ssm_state and q_head_stride == 0


def test_zamba_late_step_on_2x2(zamba):
    check_family_train(zamba)


def test_ssm_scan_meta_route_is_shape_only():
    """``meta`` inputs (the dry run): y's shape and dtype, a meta
    gradient, and no plain call counted."""
    from repro_torch.kernels.ssm_scan import ops

    ops.reset_counts()
    q = torch.empty(2, 64, 1, 16, device="meta", requires_grad=True)
    v = torch.empty(2, 64, 4, 32, dtype=torch.bfloat16, device="meta")
    la = torch.empty(2, 64, 4, device="meta")
    y = ops.ssm_scan(q.to(torch.bfloat16), q.to(torch.bfloat16), v, la)
    assert y.shape == (2, 64, 4, 32) and y.dtype == torch.bfloat16
    assert y.device.type == "meta"
    (g,) = torch.autograd.grad(y.float().sum(), q)
    assert g.shape == q.shape and g.device.type == "meta"
    assert ops.PLAIN_CALLS["ssm_scan"] == 0 and ops.LAUNCHES["ssm_scan"] == 0


def test_remat_recompute_reenters_the_callers_mesh():
    """On the card autograd recomputes a checkpointed block in its own
    thread, where the caller's (thread-local) mesh context is not set: the
    recomputation must run under the forward's mesh, or its layouts, and
    the local shapes saved for the scan's backward, differ."""
    from repro_torch.distributed.mesh_state import current_mesh, mesh_context
    from repro_torch.nn import layers as nnl

    seen = []

    def body(x):
        seen.append(current_mesh())
        return x * x             # saves x: backward recomputes

    mesh = object()
    x = torch.ones(3, requires_grad=True)
    with mesh_context(mesh):
        y = nnl.remat(body)(x).sum()
    y.backward()                 # outside the context, as on the card
    assert seen == [mesh, mesh]
    assert torch.equal(x.grad, torch.full((3,), 2.0))
