"""The int8 gradient codec (``repro.optim.compression``'s
``int8_compress`` / ``int8_decompress``): one per-tensor scale, values
rounded half to even (as ``jnp.round``) and clipped to [-127, 127].  The
all-reduce that carries the int8 payload across a mesh axis waits for the
port's mesh (ROADMAP.md, Queue 1 item 14)."""
from __future__ import annotations

from typing import Tuple

import torch


def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (q int8, scale fp32 0-d): g ~ q * scale."""
    scale = torch.clamp_min(torch.amax(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
