"""Mixture-of-Experts layer with capacity-layout aggregated expert compute
(``repro.models.moe``'s counterpart).

Top-k routing fragments the token batch into E small per-expert GEMMs
(fine-grained tasks); the layer aggregates them into grouped launches over
a static ``(E, C, d)`` capacity layout.  Dispatch is the cumsum-position
scheme: each token's position in its expert's buffer is its running count,
slot 0 of every token routed before slot 1; tokens beyond capacity are
dropped.  The expert compute takes one of the reference's two branches:

* ``kernels`` given (``kernels.ops`` by default: the CUDA kernel on the
  card, its plain version on the CPU): three ``grouped_gemm`` calls (gate,
  up, down) -- the reference's ``use_pallas`` branch, which serving runs;
* ``kernels=None``: batched einsums over the capacity slab, in
  power-of-two capacity chunks each rematerialised under autograd -- the
  reference's default (``use_pallas=False``) branch, which its training
  and full-sequence forward run.  The kernel has no backward, so training
  takes this branch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as default_kernels
from repro_torch.models.common import (
    SwiGLU, dense_init, frozen, mlp_apply, remat, stacked_init,
)


class MoE(nn.Module):
    """Router (fp32), the E routed experts stacked ``(E, d_in, d_out)``, and
    the always-on shared experts fused into one SwiGLU with its fp32 gate."""

    def __init__(self, cfg, init, dtype: torch.dtype):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = frozen(init(dense_init, d, e, torch.float32))
        self.w_gate = frozen(init(stacked_init, e, d, ff, dtype))
        self.w_up = frozen(init(stacked_init, e, d, ff, dtype))
        self.w_down = frozen(init(stacked_init, e, ff, d, dtype))
        self.shared = None
        if cfg.n_shared_experts:
            sff = cfg.n_shared_experts * (cfg.shared_expert_d_ff or cfg.d_ff)
            self.shared = SwiGLU(init, d, sff, dtype)
            self.shared_gate = frozen(init(dense_init, d, 1, torch.float32))


CAPACITY_CHUNK = 16_384   # rows per aggregated expert-GEMM chunk


def capacity_chunks(capacity: int, chunk: int = CAPACITY_CHUNK) -> int:
    """Number of (power-of-two) capacity chunks the reference scans over."""
    n = 1
    while capacity / n > chunk:
        n *= 2
    return n


def expert_capacity(n_tokens: int, cfg, capacity_factor: float = 1.25,
                    align: int = 128) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * capacity_factor))
    c = max(align, (c + align - 1) // align * align)
    n = capacity_chunks(c)
    step = align * n
    return (c + step - 1) // step * step


def _dispatch_indices(top_idx: torch.Tensor, e: int, capacity: int):
    """Positions of each (token, k) pair inside its expert's capacity
    buffer: top_idx (T, k) -> (pos (T, k) int64, keep (T, k) bool).
    Sequential priority over the k slots (slot 0 of every token routed
    first), running counts across slots -- the order that decides which
    token is dropped.  One cumsum over the pairs in that order (slot-major)
    gives the reference's per-slot loop's counts exactly."""
    t, k = top_idx.shape
    order = top_idx.T.reshape(-1).long()                        # slot-major
    onehot = F.one_hot(order, e)                                # (k T, E)
    before = torch.cumsum(onehot, dim=0) - onehot
    pos = (before * onehot).sum(dim=1).reshape(k, t).T
    return pos, pos < capacity


class Routing(NamedTuple):
    """One batch's routing: the capacity slab and how to combine it."""
    x_cap: torch.Tensor        # (E, C, d) routed rows, zero past group_len
    group_len: torch.Tensor    # (E,) int32 rows per expert, <= C
    flat_e: torch.Tensor       # (T*k,) expert of each (token, slot) pair
    flat_pos: torch.Tensor     # (T*k,) its row in the expert's buffer
    weight: torch.Tensor       # (T*k,) fp32 combine weight, 0 if dropped


def route(p: MoE, xt: torch.Tensor, cfg,
          capacity_factor: float = 1.25) -> Routing:
    """Top-k routing of xt (T, d) into the (E, C, d) capacity slab."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    # the matmul in the activation dtype, fp32 from the logits on
    logits = (xt @ p.router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.topk(probs, k, dim=-1)                # descending
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    capacity = expert_capacity(t, cfg, capacity_factor)
    pos, keep = _dispatch_indices(top_idx, e, capacity)

    # scatter into the slab through one spare row past its end, where the
    # dropped pairs land and are cut off (the reference's scatter drops
    # them out of bounds); the kept pairs own unique rows, so accumulating
    # onto zeros writes them exactly, and no host sync is needed to filter
    flat_ti = torch.arange(t * k, device=xt.device) // k
    flat_e = top_idx.reshape(-1)
    flat_pos = pos.reshape(-1)
    keep = keep.reshape(-1)
    rows = torch.where(keep, flat_e * capacity + flat_pos, e * capacity)
    slab = torch.zeros((e * capacity + 1, d), dtype=xt.dtype,
                       device=xt.device)
    slab.index_put_((rows,), xt[flat_ti], accumulate=True)
    x_cap = slab[:e * capacity].view(e, capacity, d)
    counts = torch.zeros((e,), dtype=torch.int64, device=xt.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e))
    group_len = torch.clamp(counts, max=capacity).to(torch.int32)
    # a dropped pair's index is clamped into the buffer (the reference's
    # gather clips it) and carries weight 0
    return Routing(x_cap, group_len, flat_e,
                   torch.clamp(flat_pos, max=capacity - 1),
                   (top_p.reshape(-1) * keep))


def _expert_ffn_chunked(p: MoE, x_cap: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over the (E, C, d) slab as batched einsums, in
    ``capacity_chunks(C)`` chunks, each rematerialised under autograd so
    the (E, C, ff) hidden never exists at once."""
    def body(xc):
        g = torch.einsum("ecd,edf->ecf", xc, p.w_gate)
        u = torch.einsum("ecd,edf->ecf", xc, p.w_up)
        return torch.einsum("ecf,efd->ecd", F.silu(g) * u, p.w_down)

    e, capacity, _ = x_cap.shape
    n_chunks = capacity_chunks(capacity)
    if n_chunks == 1:
        return body(x_cap)
    cc = capacity // n_chunks
    return torch.cat([remat(body, x_cap[:, i:i + cc])
                      for i in range(0, capacity, cc)], dim=1)


def moe_ffn(p: MoE, x: torch.Tensor, cfg, *, capacity_factor: float = 1.25,
            kernels=default_kernels) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); ``kernels=None`` takes the einsum branch
    (module docstring)."""
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    xt = x.reshape(t, d)
    r = route(p, xt, cfg, capacity_factor)

    if kernels is None:
        y_cap = _expert_ffn_chunked(p, r.x_cap)
    else:
        # aggregated expert compute: three grouped launches
        g = kernels.grouped_gemm(r.x_cap, p.w_gate, r.group_len)
        u = kernels.grouped_gemm(r.x_cap, p.w_up, r.group_len)
        h = F.silu(g) * u
        y_cap = kernels.grouped_gemm(h, p.w_down, r.group_len)

    # combine: gather each (token, slot) result, weight, sum over the slots
    # in order
    gathered = y_cap[r.flat_e, r.flat_pos]
    contrib = (gathered * r.weight[:, None].to(gathered.dtype)).reshape(
        t, k, d)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]

    if p.shared is not None:
        ys = mlp_apply(p.shared, xt, gated=True)
        gate = torch.sigmoid((xt @ p.shared_gate.to(xt.dtype)).float())
        y = y + ys * gate.to(ys.dtype)
    return y.reshape(b, s, d)


def aux_load_balance_loss(logits: torch.Tensor, top_idx: torch.Tensor,
                          e: int) -> torch.Tensor:
    """The Switch-style auxiliary loss: logits (T, E), top_idx (T, k) ->
    E * sum_e (mean router probability of e) x (share of tokens whose
    first choice is e)."""
    probs = torch.softmax(logits, dim=-1)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(top_idx[:, 0].long(), e).to(probs.dtype),
                    dim=0)
    return e * torch.sum(me * ce)
