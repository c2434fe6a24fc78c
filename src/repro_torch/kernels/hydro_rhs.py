"""Aggregated hydro RHS (Reconstruct + Flux + divergence, fused) as CUDA
kernels for Hopper, beside their plain PyTorch versions, in the reference's
two layouts.

``slot_grid``: ``hydro_rhs_cuda`` launches ``csrc/hydro_rhs.cu`` on the
current stream for a CUDA tensor ``(n, F, P, P, P)`` and returns ``(n, F,
S, S, S)``, one thread-block cluster of ``CLUSTER`` CTAs per x-slab of a
slot, the slabs from ``slab_plan`` (one up to 14^3, two at 15^3-17^3).
``slot_lane``: ``hydro_rhs_lane_cuda`` launches ``csrc/hydro_rhs_lane.cu``
for the lane-major ``(F, P, P, P, n)`` and returns ``(F, S, S, S, n)``, one
cluster of ``CLUSTER`` CTAs per tile of cells and ``LANES`` tasks, the tile
from ``lane_plan``.
Both raise for anything their kernel does not take and never fall back.
The cell width is a float ``h`` (uniform grid) or one width per slot,
``h_slots`` (n,): one kernel serves each layout's two Pallas kernels.  ``hydro_rhs_plain`` is the same function in PyTorch,
the counterpart of ``repro.kernels.ref.hydro_rhs_ref``;
``hydro_rhs_lane_plain`` is the reference's Pallas body on the lane-major
array (``repro.kernels.hydro_rhs._rhs_field_block`` over axes (-4, -3,
-2)).
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.hydro.euler import N_FIELDS
from repro_torch.hydro.flux import AXIS_VECS, FACE_QUAD, central_upwind
from repro_torch.hydro.ppm import DIR_PAIRS, _shift, ppm_pair
from repro_torch.hydro.stepper import subgrid_rhs
from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_PER_BLOCK

KERNEL_GHOST = 3                  # the kernels' index bounds assume g = 3
# the slot_grid kernel's launch shape, fixed in csrc/hydro_common.cuh: CTAs
# per x-slab of a slot (an axis each) and threads per CTA (one face each at
# S=8); a slot splits into at most MAX_SLABS slabs, so a cluster stays
# within the 8 CTAs every sm_90 device schedules
CLUSTER = 3
CTA_THREADS = 576
MAX_SLABS = 2
# the lane kernel's, fixed in csrc/hydro_rhs_lane.cu: tasks per cluster
# (16: a warp reads two 64-byte segments) and threads per CTA; its cluster
# is CLUSTER CTAs too
LANES = 16
LANE_THREADS = 384
# the lane kernel's tile shapes, (x, y, z) cells
LANE_TILES = ((2, 2, 2), (2, 2, 4), (2, 4, 4), (4, 4, 4))
LAYOUTS = ("slot_grid", "slot_lane")
LANE_AXES = (-4, -3, -2)          # spatial axes of a lane-major block


def hydro_rhs_plain(u_slots: torch.Tensor, *, h: Optional[float] = None,
                    h_slots: Optional[torch.Tensor] = None, gamma: float,
                    ghost: int, subgrid: int) -> torch.Tensor:
    """(n, F, P, P, P) -> (n, F, S, S, S) in plain PyTorch, any device."""
    if (h is None) == (h_slots is None):
        raise ValueError("pass exactly one of h / h_slots")
    return subgrid_rhs(u_slots, h if h_slots is None else h_slots, gamma,
                       ghost, subgrid)


def hydro_rhs_lane_plain(u_t: torch.Tensor, *, h: Optional[float] = None,
                         h_slots: Optional[torch.Tensor] = None,
                         gamma: float, ghost: int,
                         subgrid: int) -> torch.Tensor:
    """(F, P, P, P, n) -> (F, S, S, S, n) in plain PyTorch, any device: the
    reference's slot_lane kernel body with the tasks on the last axis.
    Every shift rolls the spatial axes (-4, -3, -2), the KNP flux reads the
    field axis 0, and a per-slot width ``h_slots`` (n,) broadcasts over the
    last axis.  Each (pair, side) surface value is computed once and reused
    by the quadrature entries that read it (the same values the reference
    recomputes)."""
    if (h is None) == (h_slots is None):
        raise ValueError("pass exactly one of h / h_slots")
    width = h if h_slots is None else h_slots
    g, s = ghost, subgrid
    sides = {}

    def side(pair: int, plus: int) -> torch.Tensor:
        if pair not in sides:
            sides[pair] = ppm_pair(u_t, DIR_PAIRS[pair], LANE_AXES)
        return sides[pair][plus]

    def interior(x: torch.Tensor, lo) -> torch.Tensor:
        return x[:, lo[0]:lo[0] + s, lo[1]:lo[1] + s, lo[2]:lo[2] + s, :]

    acc = None
    for axis in range(3):
        e = AXIS_VECS[axis]
        face = None
        for (w, pl, sl, pr, sr) in FACE_QUAD[axis]:
            u_right = _shift(side(pr, sr), e, 1, LANE_AXES)   # cell i+e_a
            f = w * central_upwind(side(pl, sl), u_right, axis, gamma,
                                   dim=0)
            face = f if face is None else face + f
        lo = [g, g, g]
        lo[axis] -= 1
        d = (interior(face, (g, g, g)) - interior(face, lo)) / width
        acc = -d if acc is None else acc - d
    return acc


class SlabPlan(NamedTuple):
    """The slot_grid kernel's split of a slot into x-slabs: the slab count,
    the widest slab's cells along x, the staged fields' stride and each
    field's staged floats (the widest slab's planes, widened by the
    stencil), and one CTA's dynamic shared memory in bytes (the layout
    ``csrc/hydro_rhs.cu`` reads: 16 B of alignment slack, 5 fields
    ``field_stride`` floats apart, then one axis' face fluxes over the
    widest slab)."""
    slabs: int
    width: int
    field_stride: int
    span: int
    smem: int


def _slab_layout(subgrid: int, ghost: int, slabs: int) -> SlabPlan:
    p = subgrid + 2 * ghost
    width = -(-subgrid // slabs)
    span = (width + 2 * ghost) * p * p
    # congruent to P^3 mod 4, so field f's run lies as far off a 16-byte
    # boundary in shared memory as it does in the slot
    stride = span + (p ** 3 - span) % 4
    faces = max((width + 1) * subgrid ** 2, width * (subgrid + 1) * subgrid)
    return SlabPlan(slabs, width, stride, span,
                    4 * (4 + (N_FIELDS - 1) * stride + span
                         + N_FIELDS * faces))


@lru_cache(maxsize=None)
def slab_plan(subgrid: int, ghost: int = KERNEL_GHOST) -> SlabPlan:
    """The fewest x-slabs, up to ``MAX_SLABS``, whose CTA fits the shared
    memory of an sm_90 block: one slab (the whole slot) up to 14^3, two at
    15^3-17^3.  Above that, the ``MAX_SLABS`` layout, which does not fit
    (``check_kernel_args`` raises)."""
    for slabs in range(1, MAX_SLABS + 1):
        plan = _slab_layout(subgrid, ghost, slabs)
        if plan.smem <= SMEM_PER_BLOCK:
            return plan
    return plan


def smem_bytes(subgrid: int, ghost: int = KERNEL_GHOST) -> int:
    """Dynamic shared memory of one CTA under ``slab_plan``: 4 * (4 + 5 *
    (P^3 + (S+1) * S^2)) bytes for one slab."""
    return slab_plan(subgrid, ghost).smem


def ctas_per_slot(subgrid: int, ghost: int = KERNEL_GHOST) -> int:
    """CTAs of one slot's cluster: ``CLUSTER`` per slab."""
    return CLUSTER * slab_plan(subgrid, ghost).slabs


def tile_face_grids(box: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Faces of each axis' face grid over a box of cells: one more face
    along that axis than the box has cells."""
    return tuple(math.prod(b + (d == a) for d, b in enumerate(box))
                 for a in range(3))


def lane_tiles(subgrid: int, tile: Tuple[int, int, int]
               ) -> Tuple[Tuple[int, int, int], ...]:
    """Each tile's low cell and its (possibly ragged) extent, in the
    kernel's order (x slowest): ((x0, y0, z0), (bx, by, bz)) pairs."""
    starts = [range(0, subgrid, t) for t in tile]
    return tuple(((x, y, z), tuple(min(t, subgrid - o) for t, o in
                                   zip(tile, (x, y, z))))
                 for x in starts[0] for y in starts[1] for z in starts[2])


class LanePlan(NamedTuple):
    """A lane-kernel launch: the tile, tiles per task, CTAs, dynamic shared
    memory per CTA (bytes) and face evaluations per task."""
    tile: Tuple[int, int, int]
    tiles: int
    ctas: int
    smem: int
    face_evals: int


@lru_cache(maxsize=None)
def lane_plan(subgrid: int, n: int, sms: int) -> LanePlan:
    """The lane kernel's launch for n tasks of ``subgrid``^3 on a device
    of ``sms`` SMs: of ``LANE_TILES``, the tile with the fewest face
    evaluations per task whose grid still has ``sms`` CTAs or more; if none
    has, the one with the most CTAs.  The rule is a proxy for time, not a
    model of it: on an H100 it misses the fastest tile measured at 32 x
    16^3 (PERF.md, Findings).  Which tile evaluates a face does not change
    its bits, so a task's result does not depend on the plan."""
    groups = -(-max(n, 1) // LANES)
    plans = []
    for tile in LANE_TILES:
        boxes = [box for _, box in lane_tiles(subgrid, tile)]
        most = max(max(tile_face_grids(box)) for box in boxes)
        plans.append(LanePlan(
            tile, len(boxes), CLUSTER * len(boxes) * groups,
            4 * N_FIELDS * most * LANES,
            sum(sum(tile_face_grids(box)) for box in boxes)))
    full = [p for p in plans if p.ctas >= sms]
    if full:
        return min(full, key=lambda p: p.face_evals)
    return max(plans, key=lambda p: p.ctas)


@lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_width_and_ghost(h: Optional[float],
                           h_slots: Optional[torch.Tensor],
                           ghost: int) -> None:
    """What both layouts' kernels ask of the width form and the ghost
    depth."""
    if (h is None) == (h_slots is None):
        raise ValueError("pass exactly one of h / h_slots")
    if ghost != KERNEL_GHOST:
        raise NotImplementedError(
            f"the hydro_rhs kernels take ghost={KERNEL_GHOST} only, got "
            f"{ghost} (see ROADMAP.md)")


def _check_state(u: torch.Tensor, shape: Tuple[int, ...], expect: str,
                 h_slots: Optional[torch.Tensor], n: int) -> None:
    """A contiguous float32 ``u`` of ``shape``, and ``h_slots`` (if any) a
    contiguous float32 (n,) on its device."""
    if u.dtype != torch.float32:
        raise TypeError(f"hydro_rhs kernel takes float32, got {u.dtype}")
    if tuple(u.shape) != shape:
        raise ValueError(f"expected {expect}, got {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("hydro_rhs kernel needs a contiguous input")
    if h_slots is not None and (
            h_slots.dtype != torch.float32 or h_slots.dim() != 1
            or h_slots.shape[0] != n or not h_slots.is_contiguous()
            or h_slots.device != u.device):
        raise ValueError(f"h_slots must be a contiguous float32 ({n},) "
                         f"tensor on {u.device}")


def check_kernel_args(u_slots: torch.Tensor, h: Optional[float],
                      h_slots: Optional[torch.Tensor], ghost: int,
                      subgrid: int) -> None:
    """Raise for anything the slot_grid kernel does not take (device
    aside): any sub-grid whose x-slab (``slab_plan``) and one axis' faces
    fit in shared memory, up to 17^3, odd ones included, and slots at any
    (float-aligned) address."""
    _check_width_and_ghost(h, h_slots, ghost)
    need = smem_bytes(subgrid, ghost)
    if need > SMEM_PER_BLOCK:
        raise NotImplementedError(
            f"subgrid={subgrid} needs {need} B of shared memory per block "
            f"even split into {MAX_SLABS} x-slabs (a cluster of "
            f"{CLUSTER * MAX_SLABS} CTAs), above the {SMEM_PER_BLOCK} B an "
            f"sm_90 block may use; layout='slot_lane' takes any sub-grid "
            f"size")
    p = subgrid + 2 * ghost
    n = u_slots.shape[0] if u_slots.dim() else 0
    _check_state(u_slots, (n, N_FIELDS, p, p, p),
                 f"(n, {N_FIELDS}, {p}, {p}, {p})", h_slots, n)


def check_lane_args(u_t: torch.Tensor, h: Optional[float],
                    h_slots: Optional[torch.Tensor], ghost: int,
                    subgrid: int) -> None:
    """Raise for anything the lane kernel does not take (device aside):
    a contiguous float32 ``(F, P, P, P, n)``, ghost 3, any sub-grid size
    (nothing of size P^3 is staged, so S=16 fits), int32 offsets."""
    _check_width_and_ghost(h, h_slots, ghost)
    p = subgrid + 2 * ghost
    n = u_t.shape[-1] if u_t.dim() else 0
    _check_state(u_t, (N_FIELDS, p, p, p, n),
                 f"({N_FIELDS}, {p}, {p}, {p}, n)", h_slots, n)
    if u_t.numel() >= 2 ** 31:
        raise ValueError(f"the lane kernel indexes with int32: {n} slots "
                         f"of {p}^3 are too many for one launch")


@lru_cache(maxsize=None)
def _quad_table() -> Tuple[ctypes.Array, ctypes.Array]:
    """FACE_QUAD as the kernel keeps it: 3 x 9 weights, and 3 x 9 x 8 ints,
    each entry (left pair's direction x, y, z, its side, right pair's
    direction x, y, z, its side)."""
    n = 3 * len(FACE_QUAD[0])
    weights = (ctypes.c_float * n)()
    table = (ctypes.c_int * (8 * n))()
    for a in range(3):
        for q, (w, pl, sl, pr, sr) in enumerate(FACE_QUAD[a]):
            k = a * len(FACE_QUAD[a]) + q
            weights[k] = w
            table[8 * k:8 * k + 8] = [*DIR_PAIRS[pl], sl, *DIR_PAIRS[pr], sr]
    return weights, table


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hydro_rhs_init.argtypes = [ctypes.POINTER(cf), ctypes.POINTER(ci)]
    lib.hydro_rhs_init.restype = ci
    lib.hydro_rhs_launch.argtypes = [
        vp, vp, vp, ci, ci, ci, cf, cf, cf, ctypes.c_size_t, vp]
    lib.hydro_rhs_launch.restype = ci
    lib.hydro_rhs_occupancy.argtypes = [
        ctypes.c_size_t, ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
    lib.hydro_rhs_occupancy.restype = ci
    lib.hydro_rhs_error_string.argtypes = [ci]
    lib.hydro_rhs_error_string.restype = ctypes.c_char_p


_READY_DEVICES: set = set()     # devices whose constant table is uploaded


def build() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    return _build.load("hydro_rhs", _declare)


def _ready(lib: ctypes.CDLL, device: torch.device) -> None:
    """Upload the constant table and raise the shared-memory limit on
    ``device`` (once)."""
    if device.index not in _READY_DEVICES:
        _build.raise_on(lib.hydro_rhs_init(*_quad_table()),
                        lib.hydro_rhs_error_string, "hydro_rhs kernel set-up")
        _READY_DEVICES.add(device.index)


def hydro_rhs_cuda(u_slots: torch.Tensor, *, h: Optional[float] = None,
                   h_slots: Optional[torch.Tensor] = None, gamma: float,
                   ghost: int, subgrid: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the cluster kernel on the current stream: (n, F, P, P, P) ->
    (n, F, S, S, S), ``slab_plan``'s x-slabs per slot, into ``out`` if
    given (a contiguous float32 tensor of that shape, e.g. a slice of an
    output ring; checked).  Counts each launch in
    ``hydro_rhs_cuda.launches`` (an empty bucket launches nothing)."""
    _build.refuse_grad("hydro_rhs", u_slots, h_slots)
    if u_slots.device.type != "cuda":
        raise ValueError(
            f"hydro_rhs_cuda needs a CUDA tensor, got one on "
            f"{u_slots.device}; hydro_rhs_plain is the CPU path")
    check_kernel_args(u_slots, h, h_slots, ghost, subgrid)
    n, s = u_slots.shape[0], subgrid
    out = _build.output(out, (n, N_FIELDS, s, s, s), u_slots,
                        "hydro_rhs_cuda")
    lib = build()
    if n == 0:
        return out
    plan = slab_plan(s, ghost)
    with torch.cuda.device(u_slots.device):
        _ready(lib, u_slots.device)
        stream = torch.cuda.current_stream(u_slots.device).cuda_stream
        err = lib.hydro_rhs_launch(
            u_slots.data_ptr(),
            None if h_slots is None else h_slots.data_ptr(),
            out.data_ptr(), n, s, plan.slabs,
            0.0 if h is None else float(h), gamma, gamma - 1.0, plan.smem,
            stream)
    _build.raise_on(err, lib.hydro_rhs_error_string, "hydro_rhs kernel launch")
    hydro_rhs_cuda.launches += 1
    return out


def hydro_rhs_prefix(ring: torch.Tensor, start: int, bucket: int, *,
                     h: Optional[float] = None,
                     h_slots: Optional[torch.Tensor] = None, gamma: float,
                     ghost: int, subgrid: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on a slot ring's filled prefix ``[start, start +
    bucket)`` of ``ring`` ``(capacity, F, P, P, P)``, staging-free: the
    prefix is ``ring.narrow(0, start, bucket)``, a contiguous view the
    kernel reads in place (it takes any float address).  ``h_slots``, if
    given, is the bucket's ``(bucket,)`` widths.  The counterpart of the
    reference's ``hydro_rhs_pallas_prefix``; a CPU ring takes the plain
    version."""
    if not 0 <= start <= start + bucket <= ring.shape[0]:
        raise ValueError(f"prefix [{start}, {start + bucket}) out of bounds "
                         f"for a ring of {ring.shape[0]} slots")
    u = ring.narrow(0, start, bucket)
    kw = dict(h=h, h_slots=h_slots, gamma=gamma, ghost=ghost,
              subgrid=subgrid)
    if ring.device.type == "cuda":
        return hydro_rhs_cuda(u, out=out, **kw)
    res = hydro_rhs_plain(u, **kw)
    return res if out is None else out.copy_(res)


def occupancy(device: torch.device, subgrid: int,
              ghost: int = KERNEL_GHOST) -> Tuple[int, int]:
    """(resident CTAs per SM, clusters resident on the card) for the
    cluster kernel at ``subgrid`` (``slab_plan``'s cluster), as the CUDA
    occupancy calculator gives them."""
    lib = build()
    plan = slab_plan(subgrid, ghost)
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        _ready(lib, device)
        _build.raise_on(lib.hydro_rhs_occupancy(
            plan.smem, plan.slabs, ctypes.byref(per_sm),
            ctypes.byref(clusters)),
            lib.hydro_rhs_error_string, "hydro_rhs occupancy query")
    return per_sm.value, clusters.value


hydro_rhs_cuda.launches = 0


def _declare_lane(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hydro_rhs_lane_init.argtypes = [ctypes.POINTER(cf),
                                        ctypes.POINTER(ci)]
    lib.hydro_rhs_lane_init.restype = ci
    lib.hydro_rhs_lane_launch.argtypes = [
        vp, vp, vp, ci, ci, cf, cf, cf, ci, ci, ci, ci, ctypes.c_size_t, vp]
    lib.hydro_rhs_lane_launch.restype = ci
    lib.hydro_rhs_lane_occupancy.argtypes = [
        ctypes.c_size_t, ctypes.POINTER(ci), ctypes.POINTER(ci)]
    lib.hydro_rhs_lane_occupancy.restype = ci
    lib.hydro_rhs_lane_error_string.argtypes = [ci]
    lib.hydro_rhs_lane_error_string.restype = ctypes.c_char_p


_LANE_READY_DEVICES: set = set()    # devices whose constant table is uploaded


def build_lane() -> ctypes.CDLL:
    """Build (first use) and load the lane kernel's library."""
    return _build.load("hydro_rhs_lane", _declare_lane)


def _lane_ready(lib: ctypes.CDLL, device: torch.device) -> None:
    """Upload the constant table and raise the shared-memory limit on
    ``device`` (once)."""
    if device.index not in _LANE_READY_DEVICES:
        _build.raise_on(lib.hydro_rhs_lane_init(*_quad_table()),
                        lib.hydro_rhs_lane_error_string,
                        "hydro_rhs_lane kernel set-up")
        _LANE_READY_DEVICES.add(device.index)


def hydro_rhs_lane_cuda(u_t: torch.Tensor, *, h: Optional[float] = None,
                        h_slots: Optional[torch.Tensor] = None, gamma: float,
                        ghost: int, subgrid: int) -> torch.Tensor:
    """Launch the lane kernel on the current stream: (F, P, P, P, n) ->
    (F, S, S, S, n), ``LANES`` tasks per cluster, ``lane_plan``'s tiles for
    the device's SMs.
    Counts each launch in ``hydro_rhs_lane_cuda.launches``."""
    _build.refuse_grad("hydro_rhs_lane", u_t, h_slots)
    if u_t.device.type != "cuda":
        raise ValueError(
            f"hydro_rhs_lane_cuda needs a CUDA tensor, got one on "
            f"{u_t.device}; hydro_rhs_lane_plain is the CPU path")
    check_lane_args(u_t, h, h_slots, ghost, subgrid)
    lib = build_lane()
    n, s = u_t.shape[-1], subgrid
    out = torch.empty((N_FIELDS, s, s, s, n), dtype=torch.float32,
                      device=u_t.device)
    if n == 0:
        return out
    with torch.cuda.device(u_t.device):
        plan = lane_plan(s, n, sm_count(torch.cuda.current_device()))
        _lane_ready(lib, u_t.device)
        stream = torch.cuda.current_stream(u_t.device).cuda_stream
        err = lib.hydro_rhs_lane_launch(
            u_t.data_ptr(), None if h_slots is None else h_slots.data_ptr(),
            out.data_ptr(), n, s, 0.0 if h is None else float(h), gamma,
            gamma - 1.0, *plan.tile, plan.tiles, plan.smem, stream)
    _build.raise_on(err, lib.hydro_rhs_lane_error_string,
                    "hydro_rhs_lane kernel launch")
    hydro_rhs_lane_cuda.launches += 1
    return out


def lane_occupancy(device: torch.device, subgrid: int, n: int
                   ) -> Tuple[int, int]:
    """(resident CTAs per SM, clusters resident on the card) for the lane
    kernel's launch of n tasks at ``subgrid``."""
    lib = build_lane()
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        _lane_ready(lib, device)
        plan = lane_plan(subgrid, n, sm_count(torch.cuda.current_device()))
        _build.raise_on(lib.hydro_rhs_lane_occupancy(
            plan.smem, ctypes.byref(per_sm),
            ctypes.byref(clusters)),
            lib.hydro_rhs_lane_error_string, "hydro_rhs_lane occupancy query")
    return per_sm.value, clusters.value


hydro_rhs_lane_cuda.launches = 0
