"""Roofline terms from analytic FLOPs and bytes
(``repro.launch.roofline``'s counterpart).

The compute and memory terms come from per-family formulas (the napkin
math is the point of a roofline), the same as the reference's: global
FLOPs per step (``analytic_flops``) and per-device HBM bytes per step
(``analytic_bytes``).  The collective term takes the per-device
collective bytes as given: the reference parses them from XLA's compiled
HLO (``parse_collectives_with_trips``, ``_split_computations``,
``_trip_count``), which has no counterpart without XLA's compiler, so
they are not ported and a caller without such a count passes
``{"total": 0.0}``.

The hardware constants are one card's: NVIDIA H100 80GB HBM3 (SXM),
700.00 W, dense bf16 tensor-core peak, HBM3 bandwidth and one NVLink
direction, the same figures ``chip_smoke.py`` bounds its kernels with.
"""
from __future__ import annotations

from typing import Any, Dict

# NVIDIA H100 80GB HBM3, 700.00 W
PEAK_FLOPS = 989e12        # bf16 FLOP/s, dense
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # bytes/s per NVLink direction

REMAT_FACTOR = 4.0 / 3.0   # full remat: backward replays one extra forward


# ---------------------------------------------------------------------------
# analytic FLOPs (global, per step)
# ---------------------------------------------------------------------------

def _attn_flops_fwd(cfg, tokens: int, kv_len: float) -> float:
    """QK^T + PV matmul flops for `tokens` queries against kv_len keys."""
    hq, hd = cfg.n_heads, cfg.resolved_head_dim
    return 2.0 * 2.0 * tokens * kv_len * hq * hd


def _ssd_flops_fwd(cfg, tokens: int) -> float:
    """Mamba2 chunked SSD: intra-chunk (C B^T masked) + state path."""
    inner = cfg.ssm_expand * cfg.d_model
    h = inner // 64
    n, c = cfg.ssm_state, cfg.ssm_chunk
    # CB^T (T*c*n), decay-weighted matmul (T*c*h*p), state in/out (T*n*p*h)
    p = 64
    return 2.0 * tokens * (c * n + c * h * p + 2.0 * n * p * h)


def _mlstm_flops_fwd(cfg, tokens: int) -> float:
    inner = cfg.ssm_expand * cfg.d_model
    hd = inner // cfg.n_heads
    c = cfg.ssm_chunk
    # intra-chunk qk/pv (2 * T*c*inner each) + state path (T*hd*hd per head)
    return 2.0 * tokens * (2.0 * c * inner + cfg.n_heads * hd * hd)


def analytic_flops(cfg, shape) -> Dict[str, float]:
    """Global FLOPs per step, matmul-level accounting, per family."""
    n_params = cfg.param_count(active_only=bool(cfg.n_experts))
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens, kv, fwd_mult = b * s, s / 2.0, 3.0 * REMAT_FACTOR
    elif shape.kind == "prefill":
        tokens, kv, fwd_mult = b * s, s / 2.0, 1.0
    else:
        tokens, kv, fwd_mult = b, float(s), 1.0

    mat = 2.0 * n_params * tokens          # one forward through all params
    fam = cfg.family
    mixer = 0.0
    if fam in ("dense", "moe", "vlm", "audio"):
        layers = cfg.n_layers
        if cfg.sliding_window:
            kv = min(kv, float(cfg.sliding_window))
        mixer += layers * _attn_flops_fwd(cfg, tokens, kv)
        if fam == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_every
            mixer += n_cross * _attn_flops_fwd(cfg, tokens, cfg.vision_tokens)
        if fam == "audio":
            enc_tok = tokens * cfg.encoder_seq_ratio if shape.kind != "decode" \
                else 0
            mixer += cfg.n_encoder_layers * _attn_flops_fwd(
                cfg, enc_tok, s * cfg.encoder_seq_ratio)
            mixer += cfg.n_layers * _attn_flops_fwd(
                cfg, tokens, s * cfg.encoder_seq_ratio)   # cross
    elif fam == "ssm":
        groups = cfg.n_layers // cfg.slstm_every
        mixer += (cfg.n_layers - groups) * _mlstm_flops_fwd(cfg, tokens)
        # sLSTM: sequential, 8*d^2 per token per layer (4 gates x W_x+W_h)
        mixer += groups * 2.0 * tokens * 8.0 * cfg.d_model ** 2
    elif fam == "hybrid":
        groups = cfg.n_layers // cfg.shared_attn_every
        mixer += cfg.n_layers * _ssd_flops_fwd(cfg, tokens)
        mixer += groups * _attn_flops_fwd(cfg, tokens, kv)

    total_fwd = mat + mixer
    return {"total": total_fwd * fwd_mult,
            "matmul_fwd": mat, "mixer_fwd": mixer,
            "model_flops": (6.0 if shape.kind == "train" else 2.0)
            * n_params * tokens}


# ---------------------------------------------------------------------------
# analytic HBM bytes (per device, per step)
# ---------------------------------------------------------------------------

def analytic_bytes(cfg, shape, chips: int, temp_bytes: int = 0) -> Dict[str, float]:
    """Per-device HBM traffic model.

    * params: each layer's weights are read for fwd, the remat re-forward and
      bwd (3x), grads+opt-state read/write (12 bytes/param fp32 m,v + grad)
      — FSDP means each device touches params/chips bytes.
    * activations: ~12 residual-stream-sized reads+writes per layer (qkv, o,
      norms, mlp in/out ...), bf16, batch+seq+model sharded (the SP layout);
      plus the score/prob traffic of chunked attention (f32, heads-sharded).
    """
    n_params = cfg.param_count(active_only=False)
    b, s = shape.global_batch, shape.seq_len
    dtype_b = 2
    if shape.kind == "train":
        param_traffic = n_params * (3 * dtype_b + 12)
        act_passes = 3.0
    elif shape.kind == "prefill":
        param_traffic = n_params * dtype_b
        act_passes = 1.0
    else:
        param_traffic = cfg.param_count(active_only=bool(cfg.n_experts)) \
            * dtype_b
        act_passes = 1.0

    tokens = b * (s if shape.kind != "decode" else 1)
    resid = tokens * cfg.d_model * dtype_b
    act_traffic = 12.0 * cfg.n_layers * resid * act_passes
    if cfg.family in ("dense", "moe", "vlm", "audio") and shape.kind != "decode":
        kv_eff = min(s, cfg.sliding_window) if cfg.sliding_window else s
        probs = tokens * kv_eff * cfg.n_heads * 4.0     # f32 scores once
        act_traffic += 2.0 * probs * act_passes
    if shape.kind == "decode":
        # decode reads the whole KV cache (or window/state) once per step
        hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        kv_eff = min(s, cfg.sliding_window) if cfg.sliding_window else s
        if cfg.family in ("dense", "moe", "vlm", "audio"):
            act_traffic += 2.0 * cfg.n_layers * b * kv_eff * hkv * hd * dtype_b
        elif cfg.family == "hybrid":
            groups = cfg.n_layers // cfg.shared_attn_every
            inner = cfg.ssm_expand * cfg.d_model
            act_traffic += 2.0 * groups * b * kv_eff * hkv * hd * dtype_b
            act_traffic += cfg.n_layers * b * (inner // 64) * cfg.ssm_state \
                * 64 * 4.0
        elif cfg.family == "ssm":
            inner = cfg.ssm_expand * cfg.d_model
            hd2 = (inner // cfg.n_heads) ** 2
            act_traffic += cfg.n_layers * b * cfg.n_heads * hd2 * 4.0

    per_device = (param_traffic + act_traffic) / chips
    return {"total": per_device,
            "param_traffic_global": param_traffic,
            "act_traffic_global": act_traffic}


# ---------------------------------------------------------------------------
# the three terms
# ---------------------------------------------------------------------------

def roofline_terms(cfg, shape, chips: int, coll: Dict[str, float],
                   cross_pod_fraction: float = 0.0) -> Dict[str, Any]:
    fl = analytic_flops(cfg, shape)
    by = analytic_bytes(cfg, shape, chips)
    t_compute = fl["total"] / chips / PEAK_FLOPS
    t_memory = by["total"] / HBM_BW
    t_coll = coll["total"] / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mfu_at_bound = (fl["model_flops"] / chips / PEAK_FLOPS) / bound \
        if bound > 0 else 0.0
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "analytic_flops_global": fl["total"],
        "model_flops_global": fl["model_flops"],
        "useful_flop_ratio": fl["model_flops"] / fl["total"],
        "hbm_bytes_per_device": by["total"],
        "collective_bytes_per_device": coll["total"],
        "collectives": {k: v for k, v in coll.items() if k != "total"},
        "roofline_bound_s": bound,
        "roofline_fraction": mfu_at_bound,
    }
