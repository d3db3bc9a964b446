# Copied from src/repro/configs/__init__.py; imports point at repro_torch.
"""Assigned-architecture registry: ``get("granite-8b")`` etc."""
from repro_torch.configs.base import ArchConfig, MoECfg, SHAPES, ShapeCfg, shapes_for

from repro_torch.configs.granite_8b import CONFIG as granite_8b
from repro_torch.configs.starcoder2_3b import CONFIG as starcoder2_3b
from repro_torch.configs.smollm_360m import CONFIG as smollm_360m
from repro_torch.configs.llama3_405b import CONFIG as llama3_405b
from repro_torch.configs.mixtral_8x22b import CONFIG as mixtral_8x22b
from repro_torch.configs.mixtral_8x7b import CONFIG as mixtral_8x7b
from repro_torch.configs.xlstm_1_3b import CONFIG as xlstm_1_3b
from repro_torch.configs.qwen2_vl_7b import CONFIG as qwen2_vl_7b
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2
from repro_torch.configs.zamba2_1_2b import CONFIG as zamba2_1_2b

ARCHS = {c.name: c for c in (
    granite_8b, starcoder2_3b, smollm_360m, llama3_405b, mixtral_8x22b,
    mixtral_8x7b, xlstm_1_3b, qwen2_vl_7b, seamless_m4t_large_v2, zamba2_1_2b,
)}


def get(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}") from None
