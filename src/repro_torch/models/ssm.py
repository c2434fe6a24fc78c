"""State-space and recurrent mixers: Mamba2 (SSD) and xLSTM's mLSTM and
sLSTM (``repro.models.ssm``'s counterpart).

Each mixer is an ``nn.Module`` of frozen weights (the reference's leaves,
names, shapes and dtypes: ``A_log``, ``dt_bias``, ``D``, ``w_if``,
``b_if`` and ``b`` are fp32 whatever the model's dtype) and a plain
function on tensors, ``*_apply(p, x, cfg, state=None)``:

* ``state=None``: the full-sequence form, chunked as the reference chunks
  it (``cfg.ssm_chunk``-sized blocks of dense intra-chunk products and a
  recurrence over the chunks' carries; sLSTM's h feedback makes it a loop
  over steps).  The reference's ``lax.scan`` over chunks or steps is a
  Python loop here.
* ``state`` given: one decode step (T = 1, sLSTM any T) from the state,
  returning the new state as fresh tensors.

Decode state is O(1) in the sequence length: Mamba2's conv tail (in the
model's dtype) and fp32 SSM state, mLSTM's fp32 matrix memory ``C``,
normaliser ``n`` and stabiliser ``m`` (which starts at -1e30), sLSTM's
fp32 ``h, c, n, m`` (``n`` starts at ones).  The reference computes these
mixers in ``jnp``, with no TPU kernel, so they are plain PyTorch here too.

The full-sequence forms train under autograd with the reference's
gradients: each mask is applied before its ``exp`` (``exp`` of a masked
entry would overflow, and inf x 0 would poison the backward), the
stabilisers reduce with ``amax`` and ``maximum``, which spread the
gradient over ties as ``jnp.max`` and ``jnp.maximum`` do.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import Init, dense_init, frozen, normal_init

MAMBA_HEAD_DIM = 64
CONV_WIDTH = 4
M_START = -1e30            # mLSTM's stabiliser before the first token

State = Dict[str, torch.Tensor]


def _rms(y: torch.Tensor) -> torch.Tensor:
    """y over its RMS along the last axis (eps 1e-5), in y's dtype."""
    return y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-5)


def _floor(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``: at a tie the gradient splits evenly between
    the two sides, as JAX's does (``clamp_min`` gives x all of it)."""
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype,
                                       device=x.device))


def _causal_mask(n: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))


def _chunk_of(cfg, t: int) -> int:
    """The full-sequence forms' chunk, ``min(cfg.ssm_chunk, T)``, which
    must divide T."""
    chunk = min(cfg.ssm_chunk, t)
    if t % chunk:
        raise ValueError(f"a sequence of {t} tokens is not a whole number "
                         f"of {chunk}-token chunks")
    return chunk


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

def _conv_init(gen: torch.Generator, width: int, channels: int,
               dtype: torch.dtype) -> torch.Tensor:
    return normal_init(gen, (width, channels), 0.1, dtype)


class Mamba2(nn.Module):
    """``in_proj (d, 2 inner + 2 N + H)`` (z, xBC and dt), the depthwise
    conv ``conv_w (4, inner + 2 N)`` and ``conv_b``, ``A_log``,
    ``dt_bias`` and ``D`` (H,) fp32, the gated norm's ``norm_w (inner,)``
    and ``out_proj (inner, d)``; inner = ssm_expand d, H = inner / 64."""

    def __init__(self, cfg, init: Init, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        inner = cfg.ssm_expand * d
        h = inner // MAMBA_HEAD_DIM
        n = cfg.ssm_state
        self.in_proj = frozen(init(dense_init, d, 2 * inner + 2 * n + h,
                                   dtype))
        self.conv_w = frozen(init(_conv_init, CONV_WIDTH, inner + 2 * n,
                                  dtype))
        self.conv_b = frozen(init.zeros((inner + 2 * n,), dtype))
        self.A_log = frozen(torch.log(torch.linspace(
            1.0, 16.0, h, dtype=torch.float32, device=init.device)))
        self.dt_bias = frozen(init.zeros((h,), torch.float32))
        self.D = frozen(init.ones((h,), torch.float32))
        self.norm_w = frozen(init.ones((inner,), dtype))
        self.out_proj = frozen(init(dense_init, inner, d, dtype))


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """The chunked SSD scan (Mamba2's state-passing form).  x (b, T, H, P),
    dt (b, T, H), A (H,), B, C (b, T, N) -> y (b, T, H, P)."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    nc = t // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    dA = dtc * (-torch.exp(A))                            # (b,nc,L,H) <= 0
    dA_cs = torch.cumsum(dA, dim=2)
    # decay(i, j) = exp(dA_cs[i] - dA_cs[j]) for i >= j, masked BEFORE the
    # exp (exp of the i < j entries overflows)
    diff = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]
    causal = _causal_mask(chunk, x.device)[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, diff, -math.inf))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    m = cb[..., None] * decay * dtc[:, :, None, :, :]     # (b,nc,i,j,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xc)

    # chunk-final states S_c = sum_j exp(dA_cs[L-1] - dA_cs[j]) dt_j B_j x_j^T
    last = dA_cs[:, :, -1:, :]
    w = torch.exp(last - dA_cs) * dtc
    S_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchnp", w, Bc, xc)

    # the state before each chunk
    chunk_decay = torch.exp(last[:, :, 0, :])             # (b,nc,H)
    s = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device)
    before = []
    for c in range(nc):
        before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    S_before = torch.stack(before, dim=1)                 # (b,nc,H,N,P)

    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", Cc, S_before,
                           torch.exp(dA_cs))
    return (y_intra + y_inter).reshape(b, t, h, p)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depthwise causal conv of width ``CONV_WIDTH``: x (B, T, C), w
    (W, C), after ``tail`` (B, W-1, C) or zeros -> (out, the new tail)."""
    width = w.shape[0]
    if tail is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    return out + b[None, None, :], xp[:, -(width - 1):, :]


def mamba2_apply(p: Mamba2, x: torch.Tensor, cfg,
                 state: Optional[State] = None
                 ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, T, d).  ``state=None``: the chunked scan over T (a multiple of
    ``min(cfg.ssm_chunk, T)``); a ``state`` {conv, ssm}: one decode step
    (T = 1), returning the new state."""
    b, t, d = x.shape
    inner = cfg.ssm_expand * d
    h = inner // MAMBA_HEAD_DIM
    n = cfg.ssm_state
    proj = x @ p.in_proj
    z = proj[..., :inner]
    xbc = proj[..., inner:2 * inner + 2 * n]
    dt = F.softplus(proj[..., 2 * inner + 2 * n:].float() + p.dt_bias)
    A = p.A_log
    D = p.D[None, None, :, None]

    xbc_c, conv_tail = _causal_conv(xbc, p.conv_w, p.conv_b,
                                    None if state is None else state["conv"])
    xbc_c = F.silu(xbc_c)
    xs = xbc_c[..., :inner].reshape(b, t, h, MAMBA_HEAD_DIM)
    Bm = xbc_c[..., inner:inner + n].float()
    Cm = xbc_c[..., inner + n:].float()
    if state is None:
        chunk = _chunk_of(cfg, t)
        y = _ssd_chunked(xs.float(), dt, A, Bm, Cm, chunk)
        y = y + xs.float() * D
        new_state = None
    else:
        # S' = exp(dt A) S + dt B x^T ; y = C . S'
        dA = torch.exp(dt[:, 0] * (-torch.exp(A))[None, :])          # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0], Bm[:, 0],
                           xs[:, 0].float())
        s = state["ssm"] * dA[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0], s)
        y = y[:, None] + xs.float() * D
        new_state = {"conv": conv_tail, "ssm": s}

    # the gated RMSNorm before out_proj, in fp32
    yn = _rms(y.reshape(b, t, inner))
    yn = yn * p.norm_w.float() * F.silu(z.float())
    return yn.to(x.dtype) @ p.out_proj, new_state


def mamba2_state_init(cfg, batch: int, dtype: torch.dtype = torch.float32,
                      device=None) -> State:
    """The conv tail (B, 3, inner + 2 N) in ``dtype`` and the SSM state
    (B, H, N, 64) fp32, zero."""
    inner = cfg.ssm_expand * cfg.d_model
    h = inner // MAMBA_HEAD_DIM
    return {
        "conv": torch.zeros((batch, CONV_WIDTH - 1,
                             inner + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, h, cfg.ssm_state, MAMBA_HEAD_DIM),
                           dtype=torch.float32, device=device),
    }


# ===========================================================================
# xLSTM: mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar memory)
# ===========================================================================

class MLSTM(nn.Module):
    """``up_l, up_r (d, inner)`` (the main and gate branches), ``wq, wk,
    wv (inner, inner)``, the gates ``w_if (inner, 2 H)`` and ``b_if (2
    H,)`` fp32, ``norm_w (inner,)`` and ``down (inner, d)``."""

    def __init__(self, cfg, init: Init, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        inner = cfg.ssm_expand * d
        self.up_l = frozen(init(dense_init, d, inner, dtype))
        self.up_r = frozen(init(dense_init, d, inner, dtype))
        self.wq = frozen(init(dense_init, inner, inner, dtype))
        self.wk = frozen(init(dense_init, inner, inner, dtype))
        self.wv = frozen(init(dense_init, inner, inner, dtype))
        self.w_if = frozen(init(dense_init, inner, 2 * cfg.n_heads,
                                torch.float32))
        self.b_if = frozen(init.zeros((2 * cfg.n_heads,), torch.float32))
        self.norm_w = frozen(init.ones((inner,), dtype))
        self.down = frozen(init(dense_init, inner, d, dtype))


def _mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, f_gate: torch.Tensor
                    ) -> torch.Tensor:
    """The stabilised parallel mLSTM over one chunk from a zero state.
    q, k, v (B, H, L, hd); i_gate, f_gate (B, H, L) -> y (B, H, L, hd)."""
    hd, n = q.shape[-1], q.shape[-2]
    logf = F.logsigmoid(f_gate)
    Fc = torch.cumsum(logf, dim=-1)
    D = Fc[..., :, None] - Fc[..., None, :] + i_gate[..., None, :]
    D = torch.where(_causal_mask(n, q.device), D, -math.inf)
    m = _floor(torch.amax(D, dim=-1), 0.0)
    S = torch.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(hd)
    W = S * torch.exp(D - m[..., None])
    n_vec = torch.maximum(torch.abs(torch.sum(W, dim=-1)), torch.exp(-m))
    return torch.einsum("bhij,bhjd->bhid", W, v) / n_vec[..., None]


def _mlstm_chunk(carry: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                 qi: torch.Tensor, ki: torch.Tensor, vi: torch.Tensor,
                 ii: torch.Tensor, fi: torch.Tensor):
    """One chunk of the chunkwise mLSTM from the carry (C, n, m) (C and n
    kept exp(-m)-scaled): returns the new carry and y (B, H, L, hd)."""
    C, nv, mm = carry
    hd, chunk = qi.shape[-1], qi.shape[-2]
    qi, ki, vi = qi.float(), ki.float(), vi.float()
    Fc = torch.cumsum(F.logsigmoid(fi), dim=-1)
    # intra-chunk
    D = Fc[..., :, None] - Fc[..., None, :] + ii[..., None, :]
    D = torch.where(_causal_mask(chunk, qi.device), D, -math.inf)
    # inter-chunk decay for position i: F_i plus the carried m
    d_in = Fc + mm[..., None]
    m_new = torch.maximum(torch.amax(D, dim=-1), d_in)
    m_new = _floor(m_new, 0.0)
    qs = qi / math.sqrt(hd)
    S = torch.einsum("bhid,bhjd->bhij", qs, ki)
    W = S * torch.exp(D - m_new[..., None])
    h_intra = torch.einsum("bhij,bhjd->bhid", W, vi)
    l_intra = torch.sum(W, dim=-1)
    dec = torch.exp(d_in - m_new)
    h_inter = torch.einsum("bhid,bhde,bhi->bhie", qs, C, dec)
    l_inter = torch.einsum("bhid,bhd,bhi->bhi", qs, nv, dec)
    l_tot = torch.maximum(torch.abs(l_intra + l_inter), torch.exp(-m_new))
    y = (h_intra + h_inter) / l_tot[..., None]
    # the carry at the chunk's end
    F_last = Fc[..., -1:]
    m_carry = torch.maximum(mm + F_last[..., 0],
                            torch.amax(ii + F_last - Fc, dim=-1))
    scale_old = torch.exp(mm + F_last[..., 0] - m_carry)
    add_w = torch.exp(ii + F_last - Fc - m_carry[..., None])
    C_new = C * scale_old[..., None, None] + torch.einsum(
        "bhj,bhjd,bhje->bhde", add_w, ki, vi)
    nv_new = nv * scale_old[..., None] + torch.einsum(
        "bhj,bhjd->bhd", add_w, ki)
    return (C_new, nv_new, m_carry), y


def mlstm_apply(p: MLSTM, x: torch.Tensor, cfg,
                state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """The pre-up-projected mLSTM block, x (B, T, d).  ``state=None``: the
    chunkwise form over T (one chunk: fully parallel; several: a loop with
    the (C, n, m) carry); a ``state`` {C, n, m}: one O(1) decode step."""
    b, t, d = x.shape
    inner = cfg.ssm_expand * d
    nh = cfg.n_heads
    hd = inner // nh
    xl = x @ p.up_l
    xr = F.silu(x @ p.up_r)

    def heads(w):
        return (xl @ w).reshape(b, t, nh, hd).transpose(1, 2)
    q, k, v = heads(p.wq), heads(p.wk), heads(p.wv)       # (B,H,T,hd)
    gates = xl.float() @ p.w_if + p.b_if
    i_gate = gates[..., :nh].transpose(1, 2)               # (B,H,T)
    f_gate = gates[..., nh:].transpose(1, 2)

    if state is None:
        chunk = _chunk_of(cfg, t)
        if t == chunk:
            y = _mlstm_parallel(q.float(), k.float(), v.float(), i_gate,
                                f_gate)
        else:
            carry = (x.new_zeros((b, nh, hd, hd), dtype=torch.float32),
                     x.new_zeros((b, nh, hd), dtype=torch.float32),
                     x.new_full((b, nh), M_START, dtype=torch.float32))
            ys = []
            for c0 in range(0, t, chunk):
                sl = slice(c0, c0 + chunk)
                carry, y = _mlstm_chunk(carry, q[:, :, sl], k[:, :, sl],
                                        v[:, :, sl], i_gate[..., sl],
                                        f_gate[..., sl])
                ys.append(y)
            y = torch.cat(ys, dim=2)
        new_state = None
    else:
        # C' = f C + i k v^T ; y = q.C / max(|q.n|, e^-m)
        C, nv, mm = state["C"], state["n"], state["m"]
        logf = F.logsigmoid(f_gate[..., 0])                 # (B,H)
        ii = i_gate[..., 0]
        m_new = torch.maximum(logf + mm, ii)
        fs = torch.exp(logf + mm - m_new)
        is_ = torch.exp(ii - m_new)
        k0, v0, q0 = (a[:, :, 0].float() for a in (k, v, q))
        C = C * fs[..., None, None] + is_[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", k0, v0)
        nv = nv * fs[..., None] + is_[..., None] * k0
        qs = q0 / math.sqrt(hd)
        num = torch.einsum("bhd,bhde->bhe", qs, C)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qs, nv)),
                            torch.exp(-m_new))
        y = (num / den[..., None])[:, :, None]              # (B,H,1,hd)
        new_state = {"C": C, "n": nv, "m": m_new}

    yn = _rms(y.transpose(1, 2).reshape(b, t, inner))
    yn = yn.to(x.dtype) * p.norm_w
    return (yn * xr) @ p.down, new_state


def mlstm_state_init(cfg, batch: int, device=None) -> State:
    """C (B, H, hd, hd) and n (B, H, hd) zero, m (B, H) at -1e30; fp32."""
    inner = cfg.ssm_expand * cfg.d_model
    nh = cfg.n_heads
    hd = inner // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, nh, hd, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32),
            "m": torch.full((batch, nh), M_START, **f32)}


class SLSTM(nn.Module):
    """The four gates' (i, f, z, o) input and recurrent weights ``w_x,
    w_h (d, 4 d)``, their bias ``b (4 d,)`` fp32, ``norm_w (d,)`` and
    ``down (d, d)``."""

    def __init__(self, cfg, init: Init, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.w_x = frozen(init(dense_init, d, 4 * d, dtype))
        self.w_h = frozen(init(dense_init, d, 4 * d, dtype))
        self.b = frozen(init.zeros((4 * d,), torch.float32))
        self.norm_w = frozen(init.ones((d,), dtype))
        self.down = frozen(init(dense_init, d, d, dtype))


def slstm_apply(p: SLSTM, x: torch.Tensor, cfg,
                state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """The scalar-memory sLSTM with exponential gating, a loop over T (its
    h feedback makes it sequential by design), from ``state`` {h, c, n,
    m} or the zero start (n at ones); returns the new state when one was
    given."""
    b, t, d = x.shape
    gx = (x @ p.w_x).float()                                # (B,T,4d)
    if state is None:
        fresh = slstm_state_init(cfg, b, x.device)
        h, c, n, m = fresh["h"], fresh["c"], fresh["n"], fresh["m"]
    else:
        h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    w_h = p.w_h.float()
    n_floor = torch.full((), 1e-6, dtype=torch.float32, device=x.device)
    hs = []
    for i in range(t):
        g = gx[:, i] + h @ w_h + p.b
        gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
        m_new = torch.maximum(gf + m, gi)           # the exp gates' stabiliser
        ig = torch.exp(gi - m_new)
        fg = torch.exp(gf + m - m_new)
        c = fg * c + ig * torch.tanh(gz)
        n = fg * n + ig
        h = torch.sigmoid(go) * c / torch.maximum(n, n_floor)
        m = m_new
        hs.append(h)
    yn = _rms(torch.stack(hs, dim=1))
    out = (yn.to(x.dtype) * p.norm_w) @ p.down
    new_state = None if state is None else {"h": h, "c": c, "n": n, "m": m}
    return out, new_state


def slstm_state_init(cfg, batch: int, device=None) -> State:
    """h, c, m (B, d) zero and n (B, d) ones; fp32."""
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d), **f32),
            "c": torch.zeros((batch, d), **f32),
            "n": torch.ones((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32)}
