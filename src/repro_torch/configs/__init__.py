"""The port's configs: the hydro scenarios (``sedov``, ``gravity``,
``amr_sedov``), the language models it serves and trains, and the shape
cells (``TRAIN_4K``, ``PREFILL_32K``, ``DECODE_32K``, ``LONG_500K``).

``get_config(name)`` / ``--arch <id>`` resolves a model: every
architecture of the reference's registry, in the dense, moe, ssm, hybrid,
vlm and audio families (10 architectures).
"""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
    AggregationConfig, AMRHydroConfig, GravityHydroConfig, HydroConfig,
    ModelConfig, ShapeConfig, shape_applicable, validate_ladder,
)
from repro_torch.configs.dbrx_132b import CONFIG as dbrx_132b
from repro_torch.configs.granite_8b import CONFIG as granite_8b
from repro_torch.configs.h2o_danube_1_8b import CONFIG as h2o_danube_1_8b
from repro_torch.configs.llama_3_2_vision_90b import (
    CONFIG as llama_3_2_vision_90b,
)
from repro_torch.configs.qwen1_5_32b import CONFIG as qwen1_5_32b
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as qwen2_moe_a2_7b
from repro_torch.configs.seamless_m4t_large_v2 import (
    CONFIG as seamless_m4t_large_v2,
)
from repro_torch.configs.starcoder2_15b import CONFIG as starcoder2_15b
from repro_torch.configs.xlstm_125m import CONFIG as xlstm_125m
from repro_torch.configs.zamba2_2_7b import CONFIG as zamba2_2_7b

ARCHS = {c.name: c for c in (
    starcoder2_15b, granite_8b, qwen1_5_32b, h2o_danube_1_8b, dbrx_132b,
    qwen2_moe_a2_7b, xlstm_125m, seamless_m4t_large_v2, zamba2_2_7b,
    llama_3_2_vision_90b)}


def _key(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    for cfg in ARCHS.values():
        if _key(cfg.name) == _key(name):
            return cfg
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to a CPU-smoke-testable size, preserving family
    structure (the reference's ``reduced``, copied exactly so both sides of
    a parity test build the same config)."""
    kw = dict(
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        remat=False,
        dtype="float32",
    )
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2),
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  shared_expert_d_ff=128 if cfg.shared_expert_d_ff else 0,
                  d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_chunk=16)
    if cfg.slstm_every:
        kw.update(slstm_every=2)
    if cfg.shared_attn_every:
        kw.update(shared_attn_every=2, n_layers=4)
    if cfg.n_encoder_layers:
        kw.update(n_encoder_layers=2)
    if cfg.cross_attn_every:
        kw.update(cross_attn_every=2, n_layers=4, vision_tokens=8)
    if cfg.sliding_window:
        kw.update(sliding_window=8)
    return cfg.replace(**kw)
