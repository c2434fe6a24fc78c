"""The int8 gradient codec and the int8 all-reduce with error feedback
(``repro.optim.compression``'s counterpart).

``int8_compress`` / ``int8_decompress``: one per-tensor scale, values
rounded half to even (as ``jnp.round``) and clipped to [-127, 127].

``compressed_allreduce`` carries a gradient across a ``torch.distributed``
process group as int8: one scale shared by every rank (``all_reduce``
MAX), the int8 payload summed in int32 (``all_reduce`` SUM), then
dequantized and divided by the group's size.  The residual (what
quantization lost) is carried to the next step, which keeps the scheme
convergent.  The reference runs the same arithmetic inside ``shard_map``
over a mesh axis; here each rank is one process.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (q int8, scale fp32 0-d): g ~ q * scale."""
    scale = torch.clamp_min(torch.amax(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_allreduce(g: torch.Tensor, group=None,
                         residual: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean of ``g`` over ``group`` (the default group when None)
    through an int8 payload; returns (mean gradient, new residual).
    ``residual`` is added to ``g`` first."""
    import torch.distributed as dist

    if residual is not None:
        g = g + residual
    scale = torch.clamp_min(torch.amax(torch.abs(g)), 1e-12) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    # int32 accumulation: no overflow up to 2^23 summands
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = torch.tensor(float(dist.get_world_size(group)), device=g.device)
    mean = total.float() * scale / n
    return mean, g - q.float() * scale
