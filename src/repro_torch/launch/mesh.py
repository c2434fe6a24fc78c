"""The production and test meshes (``repro.launch.mesh``'s counterpart).

The production meshes of the reference are a pod of 16 x 16 = 256 chips
and two pods, 2 x 16 x 16 = 512, with a leading ``"pod"`` axis whose
collectives cross the slow inter-pod links.  No such machine exists
here: :func:`make_production_mesh` is a :class:`Mesh` over placeholder
(meta) devices with the reference's axes and sizes, for sharding specs
and sizing only (``launch.sharding``, ``launch.dryrun``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.distributed.api import Mesh, visible_devices


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.abstract(shape, axes)


def make_test_mesh(n_data: int = 1, n_model: int = 1,
                   devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``n_data * n_model`` of
    ``devices`` (default: the visible cards; a device may repeat)."""
    devs = list(devices if devices is not None else visible_devices())
    n = n_data * n_model
    assert n <= len(devs), (n, len(devs))
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(n_data, n_model), ("data", "model"))
