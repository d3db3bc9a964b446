# Ported from src/repro/nn/xlstm.py (jax.numpy -> torch).
"""xLSTM stack: chunked-parallel mLSTM blocks with an sLSTM block every
``cfg.slstm_every`` layers (the [7:1] flavor).

mLSTM block: x -> norm -> up-projection to 2*d (value path + gate path);
q/k from the value path, per-head matrix memory via the shared chunked
linear recurrence (``kernels/ssm_scan``: the CUDA kernel on the card, the
plain ``chunked_linear_scan`` on the CPU); sigmoid input/forget gating
(stabilized exponential gating omitted, as in the reference); gated
down-projection back to d.  Under ``cfg.remat`` each mLSTM block runs under
``layers.remat`` (the reference's ``jax.remat``); in backward the scan's
gradient comes from ``ops.ScanFunction`` on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssm_scan import ops
from repro_torch.nn import layers as nnl
from repro_torch.nn import recurrent as rec
from repro_torch.nn.model import lm_loss


def _dims(cfg: ArchConfig):
    inner = 2 * cfg.d_model
    h = cfg.n_heads
    return inner, h, inner // h       # inner, heads, head_dim


def _counts(cfg: ArchConfig):
    """(sLSTM blocks, mLSTM blocks)."""
    k = cfg.slstm_every
    n_s = cfg.n_layers // k if k else 0
    return n_s, cfg.n_layers - n_s


def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device: torch.device):
    """Normal(0, 0.02) weights drawn on ``device`` from ``generator``, with
    the reference's keys and shapes; norm gains are fp32 ones."""
    dt = getattr(torch, cfg.dtype)
    d, V = cfg.d_model, cfg.vocab
    inner, h, hd = _dims(cfg)
    n_s, n_m = _counts(cfg)

    def norm(*shape):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=device).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    mlstm = {
        "ln": ones(n_m, d),
        "w_up": norm(n_m, d, 2 * inner),            # value + gate paths
        # q, k and the i/f gates from per-head block-diagonal projections
        "w_qkg": norm(n_m, h, hd, 2 * hd + 2),
        "w_down": norm(n_m, inner, d),
    }
    slstm = {
        "ln": ones(max(n_s, 1), d),
        "w_gates": norm(max(n_s, 1), d, 4 * d),
        "r_gates": norm(max(n_s, 1), d, 4 * d),
        "b_gates": torch.zeros((max(n_s, 1), 4 * d), dtype=dt, device=device),
        "w_out": norm(max(n_s, 1), d, d),
    }
    return {"embed": norm(V, d), "mlstm": mlstm, "slstm": slstm,
            "ln_f": ones(d)}


def _layer(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


def _mlstm_qkvg(cfg, x, lp):
    inner, h, hd = _dims(cfg)
    b, s, _ = x.shape
    up = x @ lp["w_up"]
    val, gate = torch.chunk(up, 2, dim=-1)                   # (B,S,inner) each
    valh = val.reshape(b, s, h, hd)
    qkg = torch.einsum("bshd,hde->bshe", valh, lp["w_qkg"])  # block-diagonal
    q = qkg[..., :hd] / hd ** 0.5
    k = qkg[..., hd:2 * hd] / hd ** 0.5
    gi = qkg[..., 2 * hd]                                    # (B,S,H)
    gf = qkg[..., 2 * hd + 1]
    v = valh
    # log sigmoid as -softplus(-x), as jax.nn.log_sigmoid computes it (its
    # backward also runs on DTensors)
    log_a = -F.softplus(-gf.float())                         # decay in (0,1)
    i_gate = torch.sigmoid(gi.float())
    return q, k, v, log_a, i_gate, gate


def _mlstm_block(cfg, x, lp, chunk: int):
    inner, h, hd = _dims(cfg)
    hin = nnl.rms_norm(x, lp["ln"])
    q, k, v, log_a, i_gate, gate = _mlstm_qkvg(cfg, hin, lp)
    k = k * i_gate[..., None].to(k.dtype)                    # input gating
    # the scan runs on each rank's local heads (replicated where they do
    # not divide the model axis)
    q, k, v = (nnl.constrain(t, "dp", None, "tp", None) for t in (q, k, v))
    y = ops.ssm_scan(q, k, v, log_a, chunk=chunk)
    b, s = y.shape[:2]
    y = y.reshape(b, s, inner) * F.silu(gate)
    return x + nnl.residual(y @ lp["w_down"])


def _slstm_block(cfg, x, lp):
    h = nnl.rms_norm(x, lp["ln"])
    y, _ = rec.slstm_scan(h, lp)
    return x + nnl.residual(y @ lp["w_out"])


def _unembed(params, x):
    """Tied unembedding; a vocab-sharded table gives vocab-sharded
    logits."""
    return nnl.constrain(x @ params["embed"].T.to(x.dtype), "dp", None, "tp")


def forward(cfg: ArchConfig, params, tokens, patch_embeds=None):
    """tokens (B, S).  Returns (logits (B,S,V), 0.0).  One ``ssm_scan`` per
    mLSTM block; an sLSTM block closes each group of ``slstm_every``."""
    x = nnl.embed(tokens, params["embed"]).to(getattr(torch, cfg.dtype))
    chunk = rec.chunk_for(x.shape[1])
    k = cfg.slstm_every
    n_groups = cfg.n_layers // k if k else 0
    per_group = k - 1 if k else 0
    mp = params["mlstm"]

    def mbody(x, lp):
        return _mlstm_block(cfg, x, lp, chunk)

    body = nnl.remat(mbody) if cfg.remat else mbody
    off = 0
    for gi in range(n_groups):
        for i in range(off, off + per_group):
            x = body(x, _layer(mp, i))
        off += per_group
        x = _slstm_block(cfg, x, _layer(params["slstm"], gi))
    for i in range(off, mp["w_up"].shape[0]):
        x = body(x, _layer(mp, i))
    x = nnl.rms_norm(x, params["ln_f"])
    return _unembed(params, x), 0.0


def loss_fn(cfg: ArchConfig, params, batch):
    logits, _ = forward(cfg, params, batch["tokens"])
    return lm_loss(logits, batch["labels"])


# --------------------------------------------------------------------- decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Constant-size recurrent state: fp32 mLSTM matrix memories and sLSTM
    (h, c), whatever ``max_len``."""
    inner, h, hd = _dims(cfg)
    n_s, n_m = _counts(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"m_state": zeros(n_m, batch, h, hd, hd),
            "s_h": zeros(max(n_s, 1), batch, cfg.d_model),
            "s_c": zeros(max(n_s, 1), batch, cfg.d_model)}


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """One token: tokens (B,).  Returns (logits (B,V), cache).

    Unlike the reference, which concatenates new states into a new cache,
    ``m_state``, ``s_h`` and ``s_c`` are updated in place (at batch 4 the
    xLSTM-1.3B ``m_state`` is 2.8 GB) and the cache itself is returned."""
    inner, h, hd = _dims(cfg)
    x = nnl.embed(tokens, params["embed"])[:, None, :].to(
        getattr(torch, cfg.dtype))
    b = x.shape[0]
    k = cfg.slstm_every
    n_groups = cfg.n_layers // k if k else 0
    per_group = k - 1 if k else 0
    mp = params["mlstm"]

    def mstep(x, i):
        lp = _layer(mp, i)
        hin = nnl.rms_norm(x, lp["ln"])
        q, kk, v, log_a, i_gate, gate = _mlstm_qkvg(cfg, hin, lp)
        kk = kk * i_gate[..., None].to(kk.dtype)
        y, _ = rec.linear_step(q[:, 0], kk[:, 0], v[:, 0], log_a[:, 0],
                               cache["m_state"][i])
        y = y.reshape(b, 1, inner) * F.silu(gate)
        return x + nnl.residual(y @ lp["w_down"])

    off = 0
    for gi in range(n_groups):
        for i in range(off, off + per_group):
            x = mstep(x, i)
        off += per_group
        sp = _layer(params["slstm"], gi)
        hin = nnl.rms_norm(x, sp["ln"])
        y, (sh, sc) = rec.slstm_step(hin[:, 0], sp,
                                     (cache["s_h"][gi], cache["s_c"][gi]))
        cache["s_h"][gi].copy_(sh)
        cache["s_c"][gi].copy_(sc)
        x = x + nnl.residual((y @ sp["w_out"])[:, None])
    for i in range(off, mp["w_up"].shape[0]):
        x = mstep(x, i)
    x = nnl.rms_norm(x, params["ln_f"])
    return _unembed(params, x)[:, 0], cache
