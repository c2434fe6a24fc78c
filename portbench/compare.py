"""The comparison that decides ``correct``.

The program's first ``steps`` RK3 steps from a cell's initial state, as
the timed window produced them (one restart segment, drawn from the
seed), against the plain reference's own first steps from the same
state: the reference computes its own Courant dt and its own states, and
reads the program's only to judge them.  Two numbers, each the worst over
the steps:

* ``increment`` — for every sub-grid of every level and every field, max
  |program - reference| over the sub-grid's cells, over max |reference -
  initial| there: each sub-grid is held to its own change since the
  initial state, so a wrong or misplaced answer in a quiet sub-grid far
  from the blast shows as plainly as one in the blast;
* ``dt`` — |dt program - dt reference| / dt reference.

A number that is not finite is infinite, and fails its limit.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

NAMES = ("increment", "dt")


def reference_steps(reference, levels: Tuple[torch.Tensor, ...], steps: int,
                    dtype: torch.dtype = torch.float32):
    """``[(dt, levels), ...]`` of the reference's first ``steps`` steps from
    ``levels``, computed in ``dtype`` (the control runs it below the
    configuration's fp32) and handed back in fp32."""
    state = tuple(u.to(dtype) for u in levels)
    out = []
    for _ in range(steps):
        dt = reference.courant(state)
        state = reference.step(state, dt)
        out.append((dt.float(), tuple(u.float() for u in state)))
    return out


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _per_subgrid_max(x: torch.Tensor, subgrid: int) -> torch.Tensor:
    """``(F, N, N, N)`` -> ``(F, G, G, G)``: the max over each sub-grid."""
    f, n = x.shape[0], x.shape[-1]
    g = n // subgrid
    return x.reshape(f, g, subgrid, g, subgrid, g, subgrid).amax(
        dim=(2, 4, 6))


def increment(program: torch.Tensor, reference: torch.Tensor,
              initial: torch.Tensor, subgrid: int) -> float:
    """The worst sub-grid and field of one level: max |program -
    reference| over max |reference - initial|."""
    diff = _per_subgrid_max((program.float() - reference).abs(), subgrid)
    change = _per_subgrid_max((reference - initial.float()).abs(), subgrid)
    never = torch.where(diff > 0, torch.full_like(diff, math.inf),
                        torch.zeros_like(diff))
    ratio = torch.where(change > 0, diff / change, never)
    return _finite(ratio.max().item())


def numbers(program: Sequence, reference: Sequence,
            initial: Tuple[torch.Tensor, ...], subgrid: int
            ) -> Dict[str, float]:
    """The numbers of ``program`` against ``reference``, each a list of
    ``(dt, levels)`` per step, from the levels ``initial``."""
    worst = dict.fromkeys(NAMES, 0.0)
    for (dt_p, lv_p), (dt_r, lv_r) in zip(program, reference, strict=True):
        dt_r64 = float(dt_r)
        worst["dt"] = max(worst["dt"], _finite(
            abs(float(dt_p) - dt_r64) / abs(dt_r64)))
        for up, ur, u0 in zip(lv_p, lv_r, initial, strict=True):
            worst["increment"] = max(worst["increment"],
                                     increment(up, ur, u0, subgrid))
    return worst


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(nums[k] <= limits[k] for k in NAMES)
