"""Public wrappers for the port's kernels, dispatching on the tensor's
device: the CUDA kernel for CUDA tensors, the plain PyTorch version for CPU
tensors.  A CUDA tensor never falls back to the plain version.  Meta
tensors take the plain version too: it gives an output's shape and dtype
without computing anything (``s2`` sizes its output ring so).

The hydro, Flux and gravity wrappers take ``out=``: the kernel writes its
result there (the plain version's is copied in), so an ``s2`` launch
writes straight into its slice of the output ring.

The hydro RHS keeps the reference's two layouts (``layout=``):
``slot_grid`` hands the ``(n, F, P, P, P)`` slots to the kernel launching
one thread-block cluster per slot, ``slot_lane`` transposes them to ``(F,
P, P, P, n)``, runs the lane kernel (tasks across each warp) and
transposes back, as the reference does around its ``pallas_call``.

The ``*_batched_body`` factories build the aggregation-region bodies the
scenarios register: the uniform hydro RHS (scalar h), the hydro RHS with a
per-task width (``level_batched_body``), the gravity solve, and the
paper's two-kernel Reconstruct + Flux body.  Each takes ``out=`` and
carries ``ops_per_task()``, its kernels' fp32 operations per task
(``kernels.counts``), which the warm-start prior reads.

The serving path reaches its two kernels, ``decode_attention`` and
``grouped_gemm``, through this module: ``models.model.decode_step`` takes
it as its ``kernels`` argument, and ``PLAIN_LM`` is the namespace of their
plain versions to swap in on the card.
"""
from __future__ import annotations

import types
from functools import lru_cache, partial
from typing import Callable, Optional

import torch

from repro_torch.configs.base import GravityHydroConfig, HydroConfig
from repro_torch.kernels.counts import (
    flux_ops, gravity_ops, hydro_rhs_ops, reconstruct_ops,
)
from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_plain,
)
from repro_torch.kernels.gravity import gravity_cuda, gravity_plain
from repro_torch.kernels.grouped_gemm import (
    grouped_gemm_cuda, grouped_gemm_plain,
)
from repro_torch.kernels.hydro_rhs import (
    LAYOUTS, hydro_rhs_cuda, hydro_rhs_lane_cuda, hydro_rhs_lane_plain,
    hydro_rhs_plain,
)
from repro_torch.kernels.hydro_split import (
    hydro_flux_cuda, hydro_flux_plain, hydro_reconstruct_cuda,
    hydro_reconstruct_plain,
)


def _dispatch(x: torch.Tensor, name: str, cuda: Callable, plain: Callable,
              *args, out: Optional[torch.Tensor] = None,
              **kw) -> torch.Tensor:
    if x.device.type == "cuda":
        if out is not None:
            kw["out"] = out
        return cuda(x, *args, **kw)
    if x.device.type in ("cpu", "meta"):
        res = plain(x, *args, **kw)
        return res if out is None else out.copy_(res)
    raise ValueError(f"no {name} path for device {x.device}")


def check_layout(layout: str) -> str:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} — valid layouts: "
                         f"{', '.join(LAYOUTS)}")
    return layout


def hydro_rhs(u_slots: torch.Tensor, *, h: Optional[float] = None,
              h_slots: Optional[torch.Tensor] = None, gamma: float,
              ghost: int, subgrid: int, layout: str = "slot_grid",
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, F, P, P, P) -> (n, F, S, S, S), in either layout, into ``out``
    if given.  Under ``slot_lane`` the two transposes are copies: the lane
    kernel reads a contiguous ``(F, P, P, P, n)``, and its ``(F, S, S, S,
    n)`` result is transposed back by one copy — into a new tensor, or
    into ``out`` (the lane body writes an ``s2`` ring slice with that one
    ``copy_``)."""
    kw = dict(h=h, h_slots=h_slots, gamma=gamma, ghost=ghost,
              subgrid=subgrid)
    if check_layout(layout) == "slot_grid":
        return _dispatch(u_slots, "hydro_rhs", hydro_rhs_cuda,
                         hydro_rhs_plain, out=out, **kw)
    if u_slots.dim() != 5:
        raise ValueError(f"expected (n, F, P, P, P), got "
                         f"{tuple(u_slots.shape)}")
    u_t = u_slots.permute(1, 2, 3, 4, 0).contiguous()
    out_t = _dispatch(u_t, "hydro_rhs_lane", hydro_rhs_lane_cuda,
                      hydro_rhs_lane_plain, **kw)
    back = out_t.permute(4, 0, 1, 2, 3)
    return back.contiguous() if out is None else out.copy_(back)


def hydro_reconstruct(u_slots: torch.Tensor) -> torch.Tensor:
    """(n, F, P, P, P) -> (n, 13, 2, F, P, P, P)."""
    return _dispatch(u_slots, "hydro_reconstruct", hydro_reconstruct_cuda,
                     hydro_reconstruct_plain)


def hydro_flux(recon: torch.Tensor, *, h: float, gamma: float, ghost: int,
               subgrid: int, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """(n, 13, 2, F, P, P, P) -> (n, F, S, S, S)."""
    return _dispatch(recon, "hydro_flux", hydro_flux_cuda, hydro_flux_plain,
                     out=out, h=h, gamma=gamma, ghost=ghost, subgrid=subgrid)


def gravity(u_slots: torch.Tensor, h_slots: torch.Tensor, *, ghost: int,
            subgrid: int, g_const: float = 1.0, n_iter: int = 8,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, F, P, P, P), (n,) -> (n, 4, S, S, S): [phi, gx, gy, gz]."""
    return _dispatch(u_slots, "gravity", gravity_cuda, gravity_plain,
                     h_slots, out=out, ghost=ghost, subgrid=subgrid,
                     g_const=g_const, n_iter=n_iter)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """(B, Hq, D) x (B, S, Hkv, D) caches, (B,) int32 -> (B, Hq, D)."""
    return _dispatch(q, "decode_attention", decode_attention_cuda,
                     decode_attention_plain, k_cache, v_cache, cache_len)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 group_len: torch.Tensor) -> torch.Tensor:
    """(E, C, K) @ (E, K, N), (E,) int32 -> (E, C, N), rows >= group_len
    zero."""
    return _dispatch(x, "grouped_gemm", grouped_gemm_cuda,
                     grouped_gemm_plain, w, group_len)


# the serving kernels' plain versions, as a drop-in for ``decode_step``'s
# ``kernels=`` on any device (the card's replay against its kernels)
PLAIN_LM = types.SimpleNamespace(decode_attention=decode_attention_plain,
                                 grouped_gemm=grouped_gemm_plain)


@lru_cache(maxsize=None)
def hydro_batched_body(cfg: HydroConfig, h: float,
                       layout: str = "slot_grid") -> Callable:
    """The uniform-grid batched task body ``(n, F, P, P, P) -> (n, F, S, S,
    S)`` with the cell width fixed: the layout's kernel on the card, its
    plain version on the CPU (``pallas_batched_body``'s counterpart).
    Cached, so scenarios of one config register the same callable (the
    tenants a ``TenantBatcher`` merges into one family)."""
    check_layout(layout)

    def batched(u_slots: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return hydro_rhs(u_slots, h=h, gamma=cfg.gamma, ghost=cfg.ghost,
                         subgrid=cfg.subgrid, layout=layout, out=out)
    batched.ops_per_task = partial(hydro_rhs_ops, 1, cfg.subgrid, cfg.ghost)
    return batched


@lru_cache(maxsize=None)
def level_batched_body(gamma: float, ghost: int, subgrid: int,
                       layout: str = "slot_grid") -> Callable:
    """The hydro body with a per-task cell width: ``(k, F, P, P, P), (k,)
    -> (k, F, S, S, S)`` (``pallas_batched_body_h``'s counterpart).
    Cached, so every scenario sharing (gamma, ghost, subgrid, layout)
    registers the same callable."""
    check_layout(layout)

    def batched(u_slots: torch.Tensor, h_slots: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return hydro_rhs(u_slots, h_slots=h_slots, gamma=gamma, ghost=ghost,
                         subgrid=subgrid, layout=layout, out=out)
    batched.ops_per_task = partial(hydro_rhs_ops, 1, subgrid, ghost)
    return batched


@lru_cache(maxsize=None)
def gravity_batched_body(cfg: GravityHydroConfig) -> Callable:
    """The gravity family's body: ``(k, F, P, P, P), (k,) -> (k, 4, S, S,
    S)``.  Cached per config."""
    hc = cfg.hydro

    def batched(u_slots: torch.Tensor, h_slots: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return gravity(u_slots, h_slots, ghost=hc.ghost, subgrid=hc.subgrid,
                       g_const=cfg.g_const, n_iter=cfg.relax_iters, out=out)
    batched.ops_per_task = partial(gravity_ops, 1, hc.subgrid, hc.ghost,
                                   cfg.relax_iters)
    return batched


def hydro_split_batched_body(cfg: HydroConfig, h: float) -> Callable:
    """The paper's two-kernel hydro body, drop-in for
    ``UniformSedovScenario(batched_body=...)``: Reconstruct writes every
    surface value, then Flux reads them back; ``(n, F, P, P, P) -> (n, F,
    S, S, S)``."""
    def batched(u_slots: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return hydro_flux(hydro_reconstruct(u_slots), h=h, gamma=cfg.gamma,
                          ghost=cfg.ghost, subgrid=cfg.subgrid, out=out)
    batched.ops_per_task = lambda: (reconstruct_ops(1, cfg.padded)
                                    + flux_ops(1, cfg.subgrid, cfg.ghost))
    return batched
