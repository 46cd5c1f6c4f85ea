"""Architecture registry: ``get_config(name)`` / ``--arch <id>`` (the port of
``repro.configs``; the config files are copies of the reference's)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeSpec

from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.internvl2_26b import CONFIG as _internvl
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen110
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2_7
from repro_torch.configs.qwen1_5_32b import CONFIG as _qwen32
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.arctic_480b import CONFIG as _arctic

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _musicgen, _internvl, _qwen110, _qwen2_7, _qwen32,
        _olmo, _mamba2, _hymba, _moonshot, _arctic,
    ]
}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Same-family smoke-test config: tiny depth/width/experts/vocab."""
    small = dict(
        n_layers=2,
        d_model=64,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        head_dim=16,
        moe_group_size=64,
        attn_chunk_q=64,
        attn_chunk_kv=64,
        dtype="float32",
    )
    if cfg.has_attention:
        small.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)))
    if cfg.is_moe:
        # generous capacity -> no token drops -> decode matches full forward
        small.update(n_experts=4, top_k=min(cfg.top_k, 2), capacity_factor=8.0)
        if cfg.moe_dense_residual:
            small.update(dense_ff=96)
    if cfg.has_ssm:
        small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.global_layers:
        small.update(global_layers=(0,), attn_window=32)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def long_context_capable(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (SSM / SWA hybrids)."""
    return cfg.family == "ssm" or (cfg.family == "hybrid" and cfg.attn_window > 0)


def shapes_for(cfg: ModelConfig) -> list[ShapeSpec]:
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not long_context_capable(cfg):
            continue  # skip noted in DESIGN.md §Arch-applicability
        out.append(s)
    return out
