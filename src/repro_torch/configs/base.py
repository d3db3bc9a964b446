# Copied from src/repro/configs/base.py; imports point at repro_torch.
"""Architecture configuration schema + the shape suite.

One ``ArchConfig`` per assigned architecture lives in configs/<id>.py; the
reduced smoke variant is derived by ``cfg.smoke()``.  Shapes follow the
assignment: train_4k / prefill_32k / decode_32k / long_500k, with per-arch
applicability (``shapes_for``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int = 8
    top_k: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 => d_model // n_heads
    act: str = "silu_gated"         # silu_gated | gelu
    moe: Optional[MoECfg] = None
    window: int = 0                 # >0 => sliding-window attention
    rope_theta: float = 1e6
    mrope: bool = False             # M-RoPE (qwen2-vl)
    tie_embeddings: bool = True
    # ssm / hybrid
    ssm_state: int = 0
    slstm_every: int = 0            # xlstm: an sLSTM block every k layers
    shared_attn_every: int = 0      # zamba2: shared attn block every k layers
    shared_attn_lora_rank: int = 0
    # enc-dec (audio)
    enc_layers: int = 0             # >0 => encoder-decoder
    # vlm stub
    n_patches: int = 0              # patch-embedding positions per sample
    # production defaults reflect the §Perf hillclimb (EXPERIMENTS.md):
    # chunked (flash-style) attention + dots-saveable remat
    dtype: str = "bfloat16"
    attn_impl: str = "xla_chunked"  # xla | xla_chunked | flash (Pallas)
    remat: bool = True
    remat_policy: str = "dots"      # full | dots (save matmul outputs)
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def n_params(self) -> float:
        """Rough parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        if self.family == "ssm":
            inner = 2 * d
            hd_i = inner // max(self.n_heads, 1)
            per_layer = (d * 2 * inner                      # up (value+gate)
                         + self.n_heads * hd_i * (2 * hd_i + 2)  # blocked qk
                         + inner * d)                       # down
        elif self.family == "hybrid":
            inner = 2 * d
            per_layer = d * inner * 2 + inner * d + inner * (2 * self.ssm_state)
        else:
            ff = d * f * (3 if self.act == "silu_gated" else 2)
            per_layer = attn + (ff * self.moe.n_experts if self.moe else ff)
        total = L * per_layer + self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.enc_layers:
            total += self.enc_layers * (attn + d * f * 2)  # encoder stack
        return float(total)

    @property
    def n_params_active(self) -> float:
        if not self.moe:
            return self.n_params
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dense_ff = d * f * 3
        return self.n_params - L * dense_ff * (self.moe.n_experts - self.moe.top_k)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if not self.shared_attn_every else 8),
            d_model=128,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=max(1, min(2, self.n_kv_heads)),
            d_head=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            moe=MoECfg(4, 2) if self.moe else None,
            window=min(self.window, 64) if self.window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            shared_attn_every=(min(self.shared_attn_every, 3)
                               if self.shared_attn_every else 0),
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            dtype="float32",
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatch: int = 0   # train only; 0 => heuristic


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}

# archs allowed to run long_500k (sub-quadratic attention; DESIGN.md §5)
SUBQUADRATIC = {"xlstm-1.3b", "zamba2-1.2b", "mixtral-8x7b", "mixtral-8x22b"}


def shapes_for(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.name in SUBQUADRATIC:
        out.append("long_500k")
    return out
