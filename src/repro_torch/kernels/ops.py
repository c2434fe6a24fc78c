"""Public wrappers for the port's kernels, dispatching on the tensor's
device: the CUDA kernel for CUDA tensors, the plain PyTorch version for CPU
tensors.  A CUDA tensor never falls back to the plain version.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import HydroConfig
from repro_torch.kernels.hydro_rhs import hydro_rhs_cuda, hydro_rhs_plain


def hydro_rhs(u_slots: torch.Tensor, *, h: Optional[float] = None,
              h_slots: Optional[torch.Tensor] = None, gamma: float,
              ghost: int, subgrid: int) -> torch.Tensor:
    """(n, F, P, P, P) -> (n, F, S, S, S)."""
    kw = dict(h=h, h_slots=h_slots, gamma=gamma, ghost=ghost,
              subgrid=subgrid)
    if u_slots.device.type == "cuda":
        return hydro_rhs_cuda(u_slots, **kw)
    if u_slots.device.type == "cpu":
        return hydro_rhs_plain(u_slots, **kw)
    raise ValueError(f"no hydro_rhs path for device {u_slots.device}")


def hydro_batched_body(cfg: HydroConfig, h: float) -> Callable:
    """The uniform-grid batched task body ``(n, F, P, P, P) -> (n, F, S, S,
    S)`` with the cell width fixed: the kernel on the card, the plain
    version on the CPU."""
    def batched(u_slots: torch.Tensor) -> torch.Tensor:
        return hydro_rhs(u_slots, h=h, gamma=cfg.gamma, ghost=cfg.ghost,
                         subgrid=cfg.subgrid)
    return batched
