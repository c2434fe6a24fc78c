"""The port's split hydro pair (Reconstruct, then Flux) against the JAX
reference, and the build cache's key.

The same inputs, made with numpy from a seed, go through ``repro`` (on the
CPU, its Pallas kernels in interpret mode) and ``repro_torch``.  Kernel-level
cases use the reference's kernel tolerance (tests/test_kernels.py):
``atol=2e-6*max|want|`` per slot and field, ``rtol=2e-5``; the pair against
the fused body uses that test's ``atol=3e-6*max|want|``.  The CUDA kernels
themselves are tested on the card by tests/test_torch_cuda.py.
"""
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import HydroConfig as JHydroConfig  # noqa: E402
from repro.hydro import state as jstate  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.hydro_rhs import (  # noqa: E402
    hydro_flux_pallas, hydro_reconstruct_pallas,
)

from repro_torch.configs.base import AggregationConfig, HydroConfig  # noqa: E402
from repro_torch.core import StrategyRunner, UniformSedovScenario  # noqa: E402
from repro_torch.hydro import flux, ppm  # noqa: E402
from repro_torch.hydro.state import sedov_init  # noqa: E402
from repro_torch.hydro.stepper import courant_dt  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import hydro_rhs as kern  # noqa: E402
from repro_torch.kernels import hydro_split as split  # noqa: E402
from repro_torch.kernels._build import SMEM_PER_BLOCK  # noqa: E402

KW = dict(h=0.01, gamma=1.4, ghost=3, subgrid=8)
CFG = HydroConfig(levels=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def assert_tol(got, want, atol_scale=2e-6, field_dim=1):
    """rtol 2e-5, atol ``atol_scale`` x max|want| of each slot and field
    (the field axis is ``field_dim``)."""
    got, want = np.asarray(got), np.asarray(want)
    axes = tuple(a for a in range(1, want.ndim) if a != field_dim)
    scale = np.abs(want).max(axis=axes, keepdims=True)
    excess = np.abs(got - want) - (atol_scale * scale + 2e-5 * np.abs(want))
    worst = np.unravel_index(np.argmax(excess), excess.shape)
    assert excess[worst] <= 0, (worst, got[worst], want[worst])


def random_slots(seed, n, s=8, g=3):
    """Random smooth-ish conserved states (n, 5, P, P, P) float32, as the
    reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    p = s + 2 * g
    rho = 1.0 + 0.3 * rng.random((n, 1, p, p, p))
    v = 0.2 * rng.standard_normal((n, 3, p, p, p))
    pr = 1.0 + 0.5 * rng.random((n, 1, p, p, p))
    e = pr / 0.4 + 0.5 * rho * np.sum(v * v, axis=1, keepdims=True)
    return np.concatenate([rho, rho * v, e], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def slots():
    """Two random slots and two of the reference's Sedov IC (the blast
    across them: near-vacuum pressure, floors and a strong jump)."""
    sedov = np.asarray(jstate.extract_subgrids(
        jstate.sedov_init(JHydroConfig(levels=1)).u, 8, 3))
    return np.concatenate([random_slots(1, 2), sedov[:2]])


@pytest.fixture(scope="module")
def ref_pair(slots):
    """The reference's jnp oracles on the same slots."""
    recon = np.asarray(jref.hydro_reconstruct_ref(jnp.asarray(slots)))
    out = np.asarray(jref.hydro_flux_ref(jnp.asarray(recon), **KW))
    return recon, out


# ---------------------------------------------------------------------------
# plain versions against the reference
# ---------------------------------------------------------------------------

def test_reconstruct_plain_matches_reference_everywhere(slots, ref_pair):
    """Every cell, the frame included (the shifts wrap as roll does)."""
    want, _ = ref_pair
    got = split.hydro_reconstruct_plain(T(slots)).numpy()
    assert got.shape == want.shape == (4, 13, 2, 5, 14, 14, 14)
    assert_tol(got, want, field_dim=3)


def test_flux_plain_matches_reference(ref_pair):
    recon, want = ref_pair
    got = split.hydro_flux_plain(T(recon), **KW).numpy()
    assert got.shape == want.shape == (4, 5, 8, 8, 8)
    assert_tol(got, want)


def test_plain_pair_matches_pallas_interpret(slots):
    """Two slots through the reference's split Pallas kernels as its tests
    run them on the CPU (interpret mode)."""
    u = slots[1:3]
    recon = hydro_reconstruct_pallas(jnp.asarray(u), interpret=True)
    want_out = np.asarray(hydro_flux_pallas(recon, interpret=True, **KW))
    got = split.hydro_reconstruct_plain(T(u))
    assert_tol(got.numpy(), np.asarray(recon), field_dim=3)
    assert_tol(split.hydro_flux_plain(got, **KW).numpy(), want_out)


def test_pair_composition_matches_fused_body(slots):
    """Reconstruct then Flux == the fused RHS, at the tolerance the
    reference holds its split kernels to (tests/test_kernels.py)."""
    u = T(slots)
    want = kern.hydro_rhs_plain(u, **KW).numpy()
    got = split.hydro_flux_plain(split.hydro_reconstruct_plain(u),
                                 **KW).numpy()
    assert_tol(got, want, atol_scale=3e-6)


def test_ops_split_body_dispatches_cpu_tensors_to_plain(slots):
    u = T(slots)
    before = (split.hydro_reconstruct_cuda.launches,
              split.hydro_flux_cuda.launches)
    body = ops.hydro_split_batched_body(CFG, KW["h"])
    recon = ops.hydro_reconstruct(u)
    assert torch.equal(recon, split.hydro_reconstruct_plain(u))
    assert torch.equal(ops.hydro_flux(recon, **KW),
                       split.hydro_flux_plain(recon, **KW))
    assert torch.equal(body(u), split.hydro_flux_plain(recon, **KW))
    assert (split.hydro_reconstruct_cuda.launches,
            split.hydro_flux_cuda.launches) == before


@pytest.mark.parametrize("agg", [
    AggregationConfig(strategy="s3", max_aggregated=4),
    AggregationConfig(strategy="s2+s3", n_executors=2, max_aggregated=2)],
    ids=["s3", "s2+s3"])
def test_split_body_on_the_uniform_path(agg):
    """Path B on the CPU: the split body through the executor equals its
    fused launch bit for bit, and the fused-kernel body within the
    per-stage tolerance compounded over 3 stages."""
    h = CFG.domain / (CFG.grids_per_edge * CFG.subgrid)
    u0 = sedov_init(CFG, device="cpu").u
    dt = courant_dt(u0, CFG)

    def run(agg_cfg, body=None):
        sc = UniformSedovScenario(CFG, batched_body=body)
        return StrategyRunner(sc, agg_cfg, device="cpu").rk3_step(u0, dt)

    body = ops.hydro_split_batched_body(CFG, h)
    fused = run(AggregationConfig(strategy="fused"), body)
    assert torch.equal(run(agg, body), fused)
    want = run(AggregationConfig(strategy="fused")).numpy()
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the kernels' index arithmetic, replayed in numpy
# ---------------------------------------------------------------------------

def _kernel_constants(source):
    """The ``constexpr int kName = N;`` constants compiled into
    ``csrc/<source>``, so the replays follow the kernel's own values."""
    text = (_build.CSRC / source).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


CU = _kernel_constants("hydro_split.cu")
RECON_THREADS, RECON_SLABS = CU["kReconThreads"], CU["kReconSlabs"]


def _recon_slab(g, p):
    """csrc/hydro_split.cu::recon_slab: the first x-plane of slab g of p
    planes; _recon_slab(RECON_SLABS, p) is p."""
    return g * p // RECON_SLABS


def _recon_smem(p):
    """Reconstruct's shared memory per CTA as hydro_reconstruct_launch sizes
    it: one field of the largest slab, widened by 2 cells on every side."""
    return 4 * (-(-p // RECON_SLABS) + 4) * (p + 4) ** 2


def _fdiv(a, b):
    """csrc/hydro_split.cu::fdiv in numpy: trunc(fma(a, 1/b, 0.5/b)) in
    float32 (the product a * (1/b) and the sum are exact in float64, then
    rounded once to float32, as the fused multiply-add rounds)."""
    inv = np.float32(1.0) / np.float32(b)
    a = np.asarray(a, np.int64)
    q = (a.astype(np.float64) * np.float64(inv)
         + np.float64(np.float32(0.5) * inv)).astype(np.float32)
    return np.trunc(q).astype(np.int64)


def _recon_stage(u, x0, x1):
    """The slab [x0, x1) of every slot and field as Reconstruct stages it:
    planes x0 - 2 .. x1 + 1, rows and columns -2 .. P + 1, each index
    wrapped mod P; flat (n, F, (x1 - x0 + 4) * Q^2), Q = P + 4, built by
    the kernel's own decomposition of the flat index."""
    p = u.shape[-1]
    q = p + 4
    i = np.arange((x1 - x0 + 4) * q * q)
    r = _fdiv(i, q)
    zz = i - r * q
    xx = _fdiv(r, q)
    yy = r - xx * q
    assert (_fdiv(i, q) == i // q).all() and (xx == r // q).all()
    return u[:, :, (x0 - 2 + xx) % p, (yy - 2) % p, (zz - 2) % p]


def _reconstruct_replay(u):
    """numpy mirror of csrc/hydro_split.cu::reconstruct_kernel's arithmetic:
    per x-slab the staged, widened field, each cell's five samples at
    cp + k * dp along each pair's direction (never outside the stage), both
    sides from the same samples."""
    n, nf, p = u.shape[0], u.shape[1], u.shape[2]
    q = p + 4
    f32 = np.float32
    _, dirs = split._split_tables()
    dirs = np.asarray(dirs).reshape(13, 3)
    out = np.empty((n, 13, 2, nf, p, p, p), np.float32)
    for g in range(RECON_SLABS):
        x0, x1 = _recon_slab(g, p), _recon_slab(g + 1, p)
        stage = _recon_stage(u, x0, x1)
        assert 4 * stage.shape[-1] <= _recon_smem(p)
        e = np.arange((x1 - x0) * p * p)
        r = _fdiv(e, p)
        z = e - r * p
        x = _fdiv(r, p)
        y = r - x * p
        cp = (x + 2) * q * q + (y + 2) * q + z + 2
        for pair, d in enumerate(dirs):
            dp = d[0] * q * q + d[1] * q + d[2]
            idx = [cp + k * dp for k in range(-2, 3)]
            assert min(i.min() for i in idx) >= 0
            assert max(i.max() for i in idx) < stage.shape[-1]
            um2, um1, u0, up1, up2 = (stage[..., i] for i in idx)
            ul = f32(7 / 12) * (um1 + u0) - f32(1 / 12) * (um2 + up1)
            ur = f32(7 / 12) * (u0 + up1) - f32(1 / 12) * (um1 + up2)
            ext = (ur - u0) * (u0 - ul) <= 0
            du, u6 = ur - ul, f32(6) * (u0 - f32(0.5) * (ul + ur))
            lo = np.where(du * u6 > du * du, f32(3) * u0 - f32(2) * ur, ul)
            hi = np.where(-(du * du) > du * u6, f32(3) * u0 - f32(2) * ul, ur)
            for side, v in ((0, lo), (1, hi)):
                out[:, pair, side, :, x0:x1] = np.where(ext, u0, v).reshape(
                    n, nf, x1 - x0, p, p)
    return out


def test_reconstruct_replay_matches_plain(slots):
    """The kernel's staged, widened slab reproduces the plain version (roll)
    at every cell, frame included."""
    got = _reconstruct_replay(slots[:2])
    want = split.hydro_reconstruct_plain(T(slots[:2])).numpy()
    assert_tol(got, want, field_dim=3)


def _reconstruct_schedule(p, offset, slot=0):
    """Store replay of csrc/hydro_split.cu::reconstruct_kernel for one slot of
    an output starting ``offset`` floats into its buffer: every CTA (field f,
    x-slab g), thread t and its cells e = t, t + RECON_THREADS, ... of the
    slab, and each pair's two plain stores.  Checks that every store lies
    inside its (pair, side, field) plane's segment of the slab and returns
    how often each element (13, 2, F, P^3) was written."""
    p2, p3 = p * p, p ** 3
    count = np.zeros(13 * 2 * 5 * p3, int)
    slot_start = offset + slot * 13 * 2 * 5 * p3
    for f in range(5):
        for g in range(RECON_SLABS):
            x0, x1 = _recon_slab(g, p), _recon_slab(g + 1, p)
            length = (x1 - x0) * p2
            dst = slot_start + f * p3 + x0 * p2
            # every thread's cells, thread by thread
            e = np.concatenate([np.arange(t, length, RECON_THREADS)
                                for t in range(RECON_THREADS)])
            for pair in range(13):
                for side in (0, 1):
                    at = dst + (pair * 2 + side) * 5 * p3 + e
                    plane = (pair * 2 + side) * 5 + f
                    seg = slot_start + plane * p3 + x0 * p2
                    assert ((at >= seg) & (at < seg + length)).all()
                    np.add.at(count, at - slot_start, 1)
    return count.reshape(13, 2, 5, p3)


@pytest.mark.parametrize("p", [11, 14, 22, 3])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_reconstruct_schedule_writes_each_element_once(p, offset):
    """At odd P (planes off 16-byte boundaries), at the main path's P = 14,
    at 16^3's P = 22 and at P = 3 (fewer planes than slabs), for an output
    at and off a 16-byte boundary and for the next slot too: every (pair,
    side, field, cell) element is written exactly once, each store inside
    its plane's slab segment."""
    for slot in (0, 1):
        assert (_reconstruct_schedule(p, offset, slot) == 1).all()


def test_fdiv_is_floor_division_where_the_kernel_uses_it():
    """Reconstruct's fp32 floor division is exact for the divisors P and
    P + 4 over every dividend the kernel gives them (slab cells, staged
    indices and their rows), up to the largest P it takes (62), where its
    staged slab still fits shared memory."""
    top = split.RECON_MAX_PADDED
    for p in range(3, top + 1):
        q = p + 4
        planes = -(-p // RECON_SLABS)
        for b, n in ((p, planes * p * p), (q, (planes + 4) * q * q)):
            a = np.arange(n)
            np.testing.assert_array_equal(_fdiv(a, b), a // b)
    assert _recon_smem(top) <= SMEM_PER_BLOCK < _recon_smem(top + 1)


def _flux_schedule(s, g=3):
    """Index replay of csrc/hydro_split.cu::flux_cluster_kernel for one slot
    of ``s``^3: CTA a of the cluster owns axis a's faces, thread t its faces
    fi = t, t + 576, ...; before each face the thread primes its ring with
    the first quadrature entries, and loading entry q issues entry
    q + FLUX_STAGES - 1 into stage (q + FLUX_STAGES - 1) % FLUX_STAGES.
    Returns, per axis, each face's staged (left, right) flat offsets into
    the slot's (13, 2, F, P, P, P) block per entry (nface, 9, 2, F), and
    checks on the way that every stage a thread reads holds the entry it
    wants, staged by that thread and not overwritten since, and that every
    ring and face-buffer index lies in the CTA's shared memory."""
    p = s + 2 * g
    p3 = p ** 3
    threads, stages, nf = kern.CTA_THREADS, split.FLUX_STAGES, 5
    _, table = kern._quad_table()
    t = np.asarray(table).reshape(3, 9, 8)
    pq = np.asarray(split._split_tables()[0]).reshape(3, 9, 2)
    ring_floats = stages * 2 * nf * threads
    offsets = []
    for a in range(3):
        ny, nz = s + (a == 1), s + (a == 2)
        nface = (s + (a == 0)) * ny * nz
        e = (p * p, p, 1)[a]
        # the face buffer follows the ring; both within the CTA's bytes
        assert 4 * (ring_floats + nf * nface) == split.flux_smem_bytes(s)
        offs = np.empty((nface, 9, 2, nf), np.int64)
        for tid in range(threads):
            ring = {}                       # stage -> (face, entry)
            for fi in range(tid, nface, threads):
                z, y, x = fi % nz, (fi // nz) % ny, fi // (nz * ny)
                c = ((g + x - (a == 0)) * p * p + (g + y - (a == 1)) * p
                     + (g + z - (a == 2)))

                def issue(q):
                    if q >= 9:
                        return
                    stg = q % stages
                    # the stage's last entry was consumed (or never used)
                    assert ring.get(stg, (None, 9))[1] == 9, (a, tid, fi, q)
                    ring[stg] = (fi, q)
                    for f in range(nf):
                        for k, side in ((f, 0), (nf + f, 1)):
                            assert (stg * 2 * nf + k) * threads + tid \
                                < ring_floats
                        offs[fi, q, 0, f] = (
                            (pq[a, q, 0] * 2 + t[a, q, 3]) * nf + f) * p3 + c
                        offs[fi, q, 1, f] = (
                            (pq[a, q, 1] * 2 + t[a, q, 7]) * nf + f) * p3 \
                            + c + e

                for q in range(stages - 1):
                    issue(q)
                for q in range(9):
                    issue(q + stages - 1)
                    assert ring[q % stages] == (fi, q), (a, tid, fi, q)
                    ring[q % stages] = (fi, 9)       # consumed
        offsets.append(offs)
    return offsets


def _flux_replay(recon, h, gamma, s=8, g=3):
    """numpy float32 mirror of csrc/hydro_split.cu::flux_cluster_kernel:
    each axis' faces from the states its threads stage (``_flux_schedule``'s
    offsets), face_flux's order over the quadrature entries, and the
    divergence of each CTA's third of the cells from the three axes' face
    buffers.  Returns the result, the range of every cell index read, and
    how often each cell was written."""
    n, nf, p = recon.shape[0], recon.shape[3], recon.shape[4]
    flat = recon.reshape(n, -1)
    weights, _ = kern._quad_table()
    w = np.asarray(weights, np.float32).reshape(3, 9)
    f32 = np.float32
    lo_idx, hi_idx = p ** 3, -1

    def prim(q):
        rho = np.maximum(q[:, 0], f32(1e-10))
        vel = q[:, 1:4] / rho[:, None]
        ke = f32(0.5) * rho * (vel[:, 0] ** 2 + vel[:, 1] ** 2
                               + vel[:, 2] ** 2)
        pr = np.maximum(f32(gamma - 1.0) * (q[:, 4] - ke), f32(1e-12))
        return rho, vel, pr

    def phys(q, vel, pr, a):
        v = vel[:, a]
        f = q * v[:, None]
        f[:, 4] = (q[:, 4] + pr) * v
        f[:, 1 + a] += pr
        return f

    faces = []
    for a, offs in enumerate(_flux_schedule(s, g)):
        cell = offs % p ** 3
        lo_idx, hi_idx = min(lo_idx, cell.min()), max(hi_idx, cell.max())
        assert offs.min() >= 0 and offs.max() < 13 * 2 * nf * p ** 3
        acc = None
        for q in range(9):
            qL = np.moveaxis(flat[:, offs[:, q, 0]], 2, 1)    # (n, F, face)
            qR = np.moveaxis(flat[:, offs[:, q, 1]], 2, 1)
            (rL, vL, pL), (rR, vR, pR) = prim(qL), prim(qR)
            cL = np.sqrt(f32(gamma) * pL / rL)
            cR = np.sqrt(f32(gamma) * pR / rR)
            ap = np.maximum(np.maximum(vL[:, a] + cL, vR[:, a] + cR), 0)
            am = np.minimum(np.minimum(vL[:, a] - cL, vR[:, a] - cR), 0)
            fL, fR = phys(qL, vL, pL, a), phys(qR, vR, pR, a)
            span = ap - am
            ok = span > f32(1e-12)
            inv = np.where(ok, f32(1) / np.maximum(span, f32(1e-12)), 0)
            ap, am, inv, ok = (v[:, None] for v in (ap, am, inv, ok))
            fl = np.where(ok, (ap * fL - am * fR) * inv
                          + (ap * am) * inv * (qR - qL),
                          f32(0.5) * (fL + fR))
            acc = w[a, q] * fl if acc is None else acc + w[a, q] * fl
        faces.append(acc)
    s3 = s ** 3
    out = np.empty((n, nf, s3), np.float32)
    written = np.zeros(s3, int)
    share = -(-s3 // 3)
    for rank in range(3):
        ci = np.arange(rank * share, min(s3, (rank + 1) * share))
        written[ci] += 1
        z, y, x = ci % s, (ci // s) % s, ci // (s * s)
        acc = None
        for a in range(3):
            ny, nz = s + (a == 1), s + (a == 2)
            lo = (x * ny + y) * nz + z
            d = (faces[a][:, :, lo + (ny * nz, nz, 1)[a]]
                 - faces[a][:, :, lo]) / f32(h)
            acc = -d if acc is None else acc - d
        out[:, :, ci] = acc
    return out.reshape(n, nf, s, s, s), (lo_idx, hi_idx), written


def test_flux_replay_stays_in_block_and_matches_plain(ref_pair):
    """The Flux kernel's face ownership, staging ring, pair table and
    divergence split, replayed in numpy, read only cells of the padded
    block, write each output cell once and give the plain version's
    result."""
    recon, _ = ref_pair
    got, (lo, hi), written = _flux_replay(recon, KW["h"], KW["gamma"])
    assert 0 <= lo and hi <= 14 ** 3 - 1
    assert (written == 1).all()
    want = split.hydro_flux_plain(T(recon), **KW).numpy()
    assert_tol(got, want)


@pytest.mark.parametrize("s", [4, 5, 10])
def test_flux_schedule_owns_each_face_once(s):
    """At sub-grids where a thread owns no face (4, 5) or two (10): each
    consumed face is evaluated once, by its axis' CTA; every staged value
    is the state its face's entry needs, inside the slot's block; the
    staged values of each axis are the distinct states ``flux_read_states``
    counts."""
    g, p = 3, s + 6
    offs = _flux_schedule(s, g)
    distinct = set()
    for a, o in enumerate(offs):
        assert o.shape[0] == (s + 1) * s * s
        assert 0 <= o.min() and o.max() < 13 * 2 * 5 * p ** 3
        plane, cell = o // p ** 3, o % p ** 3
        x, y, z = cell // (p * p), (cell // p) % p, cell % p
        assert ((x >= 0) & (x < p) & (y >= 0) & (y < p)).all()
        pair, side = plane // 10, (plane // 5) % 2
        distinct |= set(zip(pair[..., 0].ravel(), side[..., 0].ravel(),
                            x[..., 0].ravel(), y[..., 0].ravel(),
                            z[..., 0].ravel()))
    want = {(pl, sd, *c) for (pl, sd, c) in split.flux_read_states(s, g)}
    assert distinct == want


def test_split_tables_match_face_quad():
    pairs, dirs = split._split_tables()
    assert [tuple(np.asarray(dirs).reshape(13, 3)[i])
            for i in range(13)] == ppm.DIR_PAIRS
    pq = np.asarray(pairs).reshape(3, 9, 2)
    for a in range(3):
        for q, (_, pl, _, pr, _) in enumerate(flux.FACE_QUAD[a]):
            assert tuple(pq[a, q]) == (pl, pr)


def test_flux_read_count_is_pinned():
    """The distinct (pair, side, field, cell) values the Flux function
    reads, which set its bound's bytes: the count chip_smoke.py uses."""
    states = split.flux_read_states(8)
    # 3 axes x 9 entries x 2 states x 576 faces = 31,104 reads, of which
    # 16,768 distinct: 171.7 MB for 512 slots
    assert len(states) == 16_768
    assert split.flux_read_bytes(512, 8) == 512 * 16_768 * 5 * 4
    # every one lies inside the padded block
    assert all(0 <= x < 14 for (_, _, c) in states for x in c)
    # the reconstruction Reconstruct writes, for the same 512 slots
    assert 512 * 13 * 2 * 5 * 14 ** 3 * 4 == 730_562_560


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take(slots):
    u = T(slots[:2])
    recon = split.hydro_reconstruct_plain(u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        split.hydro_reconstruct_cuda(u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        split.hydro_flux_cuda(recon, **KW)
    with pytest.raises(TypeError, match="float32"):
        split.check_reconstruct_args(u.double())
    with pytest.raises(ValueError, match="expected"):
        split.check_reconstruct_args(u[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        split.check_reconstruct_args(u.transpose(2, 3))
    with pytest.raises(ValueError, match="P >= 3"):
        split.check_reconstruct_args(torch.zeros((1, 5, 2, 2, 2)))
    with pytest.raises(NotImplementedError, match="shared memory"):
        split.check_reconstruct_args(torch.zeros((1, 5, 63, 63, 63)))
    split.check_reconstruct_args(torch.zeros((1, 5, 62, 62, 62)))
    split.check_reconstruct_args(u)
    with pytest.raises(NotImplementedError, match="ghost=3"):
        split.check_flux_args(recon, ghost=2, subgrid=10)
    with pytest.raises(ValueError, match="expected"):
        split.check_flux_args(recon[:, :12], ghost=3, subgrid=8)
    with pytest.raises(ValueError, match="contiguous"):
        split.check_flux_args(recon.transpose(5, 6), ghost=3, subgrid=8)
    split.check_flux_args(recon, ghost=3, subgrid=8)
    # one field of a 2-plane slab widened to 6 x 18 x 18
    assert _recon_smem(14) == 7_776
    # the staging ring (2 entries x 10 values x 576 threads) and one axis'
    # face fluxes
    assert split.flux_smem_bytes(8) == 57_600


# ---------------------------------------------------------------------------
# the build cache's key covers the shared header
# ---------------------------------------------------------------------------

def test_build_digest_covers_headers(tmp_path):
    """Editing a header that a source includes changes the source's
    library key, so an edited header rebuilds instead of loading a stale
    library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    keys = {name: _build._digest(csrc / f"{name}.cu")
            for name in ("hydro_rhs", "hydro_split", "gravity")}
    assert keys["hydro_rhs"] == _build._digest(_build.CSRC / "hydro_rhs.cu")
    header = csrc / "hydro_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name in ("hydro_rhs", "hydro_split"):
        assert _build._digest(csrc / f"{name}.cu") != keys[name]
    (csrc / "hydro_rhs.cu").write_text(
        (csrc / "hydro_rhs.cu").read_text() + "\n")
    assert _build._digest(csrc / "hydro_rhs.cu") != keys["hydro_rhs"]
