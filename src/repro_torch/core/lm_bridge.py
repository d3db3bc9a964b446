# Copied from src/repro/core/lm_bridge.py; imports point at repro_torch.
"""DNNVM planner applied to a transformer block (DESIGN.md §3).

The block is expressed as an XGraph-style op chain with LM ops
(matmul / attn_score / softmax / attn_av / add / norm); the same three-step
DNNVM pipeline runs against the TPU device model:

  1. template embeddings — the attention kernel-fusion template
     (attn_score -> softmax -> attn_av) plus point-wise groups;
  2. fusion condition 1 — a VMEM-capacity check for the fused group's
     blocked working set (the flash-attention tiling: q tile + kv blocks +
     running stats resident on-chip);
  3. cost-based path selection — fused vs unfused HBM traffic + FLOP time;
     the unfused form pays the S x S score-matrix round trip to HBM.

The chosen strategy maps to the execution impl: fused attention group =>
the Pallas flash-attention kernel; per-arch planner decisions are logged in
EXPERIMENTS.md §Repro.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.hw import DeviceModel, TPU_V5E


@dataclasses.dataclass
class AttnPlan:
    fused: bool              # True => flash kernel; False => unfused XLA
    blk_q: int
    blk_k: int
    fused_cost_s: float
    unfused_cost_s: float
    vmem_bytes: int
    reason: str


def plan_attention(cfg: ArchConfig, seq_len: int, batch_per_device: int,
                   dev: DeviceModel = TPU_V5E, elem_bytes: int = 2) -> AttnPlan:
    """Cost the fused (flash) vs unfused attention for one block.

    Fusion condition 1 (paper §4): the blocked working set —
    q tile (blk_q x d), k/v blocks (2 x blk_k x d), score tile
    (blk_q x blk_k) and accumulators — must fit the VMEM budget.  Block
    sizes start MXU-aligned (128) and halve until they fit.
    """
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = seq_len
    b = max(1, batch_per_device)
    g = max(1, h // kv)
    vmem = dev.onchip_bytes

    blk_q = blk_k = 128
    while blk_q >= 8:
        work = (blk_q * g * d + 2 * blk_k * d + blk_q * g * blk_k
                + 2 * blk_q * g * d) * 4  # fp32 accumulators
        if work <= vmem:
            break
        blk_q //= 2
        blk_k //= 2
    feasible = blk_q >= 8

    # traffic (per device, one head-group pass, causal ~ 1/2 the square)
    qkv_bytes = b * s * (h + 2 * kv) * d * elem_bytes
    out_bytes = b * s * h * d * elem_bytes
    score_bytes = b * kv * g * s * s * elem_bytes // 2
    flops = 2 * b * h * s * s * d  # QK^T + AV, causal halves, x2 terms cancel

    t_compute = flops / dev.peak_ops_per_s
    bw = dev.dram_bw_bytes_per_s
    # unfused: scores written + read twice (softmax read/write, AV read)
    unfused = max(t_compute, (qkv_bytes + out_bytes + 3 * score_bytes) / bw)
    fused = max(t_compute, (qkv_bytes + out_bytes) / bw)

    if not feasible:
        return AttnPlan(False, 0, 0, float("inf"), unfused, vmem,
                        "no block size fits VMEM (condition 1 fails)")
    if fused <= unfused:
        return AttnPlan(True, blk_q, blk_k, fused, unfused, vmem,
                        f"fused saves {(unfused - fused) * 1e3:.2f} ms "
                        f"(score matrix {score_bytes / 1e9:.2f} GB stays on-chip)")
    return AttnPlan(False, blk_q, blk_k, fused, unfused, vmem,
                    "unfused cheaper (short sequence)")


def plan_ssm_chunk(cfg: ArchConfig, seq_len: int,
                   dev: DeviceModel = TPU_V5E) -> int:
    """Chunk length for the linear-recurrence kernels: largest power-of-two
    L <= 512 whose (3 L d + L^2 + K V) fp32 working set fits VMEM — the same
    Eq. 5/6 vocabulary, applied to the SSD scan (DESIGN.md §5)."""
    inner = 2 * cfg.d_model
    h = max(cfg.n_heads, 1)
    dk = cfg.ssm_state or inner // h
    dv = inner // h
    vmem = dev.onchip_bytes
    L = 512
    while L > 16:
        work = (3 * L * max(dk, dv) + L * L + dk * dv) * 4
        if work <= vmem and seq_len % L == 0:
            return L
        L //= 2
    return max(16, L)


def report(cfg: ArchConfig, seq_len: int = 32768,
           batch_per_device: int = 1) -> str:
    if cfg.family in ("ssm", "hybrid"):
        L = plan_ssm_chunk(cfg, seq_len)
        return (f"{cfg.name}: chunked scan, chunk={L} "
                f"(condition-1 tiling on VMEM)")
    p = plan_attention(cfg, seq_len, batch_per_device)
    kind = "FUSED flash kernel" if p.fused else "unfused XLA"
    return (f"{cfg.name}: attention group -> {kind} "
            f"(blk_q={p.blk_q}, blk_k={p.blk_k}; fused "
            f"{p.fused_cost_s*1e3:.2f} ms vs unfused "
            f"{p.unfused_cost_s*1e3:.2f} ms) — {p.reason}")
