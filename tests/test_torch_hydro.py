"""The port's hydro modules and kernel module against the JAX reference.

The same inputs, made with numpy from a seed, go through ``repro`` (on the
CPU) and ``repro_torch``.  Kernel-level cases use the reference's own
kernel tolerance (tests/test_kernels.py): ``atol=2e-6*max(scale, 1)``,
``rtol=2e-5``.  The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import HydroConfig as JHydroConfig  # noqa: E402
from repro.hydro import flux as jflux  # noqa: E402
from repro.hydro import ppm as jppm  # noqa: E402
from repro.hydro import state as jstate  # noqa: E402
from repro.hydro import stepper as jstepper  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.hydro_rhs import hydro_rhs_pallas  # noqa: E402

from repro_torch.configs.base import HydroConfig  # noqa: E402
from repro_torch.configs.sedov import CONFIG_16  # noqa: E402
from repro_torch.hydro import flux, ppm, state, stepper  # noqa: E402
from repro_torch.kernels import hydro_rhs as kern  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

KW = dict(h=0.01, gamma=1.4, ghost=3, subgrid=8)
JCFG = JHydroConfig(levels=1)
CFG = HydroConfig(levels=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(want):
    scale = float(np.max(np.abs(want)))
    return dict(atol=2e-6 * max(scale, 1.0), rtol=2e-5)


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
def sedov_slots():
    """Padded sub-grids of the reference's Sedov IC at levels=1 (the blast
    sits across all 8): near-vacuum pressure, floors and a strong jump."""
    u = jstate.sedov_init(JCFG).u
    return np.asarray(jstate.extract_subgrids(u, 8, 3))


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


# ---------------------------------------------------------------------------
# tables and modules
# ---------------------------------------------------------------------------

def test_tables_match_reference():
    assert ppm.DIR_PAIRS == jppm.DIR_PAIRS
    assert len(ppm.DIR_PAIRS) == 13
    assert flux.FACE_QUAD == jflux.FACE_QUAD
    assert all(len(flux.FACE_QUAD[a]) == 9 for a in range(3))


def test_ppm_reconstruct_all_matches_reference():
    u = random_slots(1, 1)[0]
    want = np.asarray(jppm.ppm_reconstruct_all(jnp.asarray(u)))
    got = ppm.ppm_reconstruct_all(T(u)).numpy()
    assert got.shape == want.shape == (13, 2, 5, 14, 14, 14)
    np.testing.assert_allclose(got, want, **_tol(want))


def test_ppm_reconstruct_batched_equals_per_slot():
    u = T(random_slots(2, 3))
    batched = ppm.ppm_reconstruct_all(u)
    for i in range(3):
        assert torch.equal(batched[i], ppm.ppm_reconstruct_all(u[i]))


def test_flux_divergence_matches_reference():
    u = random_slots(3, 1)[0]
    recon = np.asarray(jppm.ppm_reconstruct_all(jnp.asarray(u)))
    want = np.asarray(jflux.flux_divergence(jnp.asarray(recon), **KW))
    got = flux.flux_divergence(T(recon), **KW).numpy()
    np.testing.assert_allclose(got, want, **_tol(want))


@pytest.mark.parametrize("source", ["random", "sedov"])
def test_subgrid_rhs_matches_reference(source, sedov_slots):
    u = random_slots(4, 1)[0] if source == "random" else sedov_slots[0]
    h = KW["h"] if source == "random" else 1.0 / 16
    kw = dict(KW, h=h)
    want = np.asarray(jstepper.subgrid_rhs(jnp.asarray(u), **kw))
    got = stepper.subgrid_rhs(T(u), **kw).numpy()
    np.testing.assert_allclose(got, want, **_tol(want))


# ---------------------------------------------------------------------------
# the kernel module: plain version, dispatch, argument checks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_three_slots():
    u = random_slots(11, 3)
    return u, np.asarray(jref.hydro_rhs_ref(jnp.asarray(u), **KW))


@pytest.mark.parametrize("n_slots", [1, 3])
def test_hydro_rhs_plain_matches_ref(n_slots, ref_three_slots):
    u, ref = ref_three_slots
    want = ref[:n_slots]
    got = kern.hydro_rhs_plain(T(u[:n_slots]), **KW).numpy()
    assert got.shape == (n_slots, 5, 8, 8, 8)
    np.testing.assert_allclose(got, want, **_tol(want))


def test_hydro_rhs_plain_matches_pallas_interpret(sedov_slots):
    """Two slots through the Pallas slot_grid kernel as the reference's
    tests run it on the CPU (interpret mode)."""
    u = np.concatenate([random_slots(20, 1), sedov_slots[:1]])
    want = np.asarray(hydro_rhs_pallas(jnp.asarray(u), layout="slot_grid",
                                       interpret=True, **KW))
    got = kern.hydro_rhs_plain(T(u), **KW).numpy()
    np.testing.assert_allclose(got, want, **_tol(want))


def test_hydro_rhs_plain_h_slots_equals_per_width():
    """Per-slot widths: each slot equals the scalar-width call bit for bit
    (the traced-h mode of the reference's _kernel_slot_grid_h)."""
    u = T(random_slots(30, 4))
    hs = torch.tensor([0.02, 0.01, 0.02, 0.01], dtype=torch.float32)
    kw = dict(gamma=1.4, ghost=3, subgrid=8)
    mixed = kern.hydro_rhs_plain(u, h_slots=hs, **kw)
    for i in range(4):
        one = kern.hydro_rhs_plain(u[i:i + 1], h=float(hs[i]), **kw)
        assert torch.equal(mixed[i:i + 1], one)


def test_ops_dispatches_cpu_tensors_to_plain():
    u = T(random_slots(40, 2))
    before = kern.hydro_rhs_cuda.launches
    got = ops.hydro_rhs(u, **KW)
    assert torch.equal(got, kern.hydro_rhs_plain(u, **KW))
    assert kern.hydro_rhs_cuda.launches == before


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    u = T(random_slots(41, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.hydro_rhs_cuda(u, **KW)
    kw = dict(h=0.01, h_slots=None)
    with pytest.raises(NotImplementedError, match="ghost=3"):
        kern.check_kernel_args(u, ghost=2, subgrid=10, **kw)
    p18 = 18 + 6
    u18 = torch.zeros((1, 5, p18, p18, p18))
    with pytest.raises(NotImplementedError, match="slot_lane"):
        kern.check_kernel_args(u18, ghost=3, subgrid=18, **kw)
    with pytest.raises(TypeError, match="float32"):
        kern.check_kernel_args(u.double(), ghost=3, subgrid=8, **kw)
    with pytest.raises(ValueError, match="expected"):
        kern.check_kernel_args(u[:, :4], ghost=3, subgrid=8, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kern.check_kernel_args(u.transpose(2, 3), ghost=3, subgrid=8, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        kern.check_kernel_args(u, 0.01, torch.ones(1), 3, 8)
    with pytest.raises(ValueError, match="h_slots"):
        kern.check_kernel_args(u, None, torch.ones(2), 3, 8)
    kern.check_kernel_args(u, None, torch.ones(1), 3, 8)
    # the main path's shape fits: ~66 KB per CTA of a 3-CTA cluster (16 B
    # of alignment slack, the padded slot and one axis' faces)
    assert kern.smem_bytes(8) == 66_416


def test_kernel_wrapper_takes_odd_misaligned_and_16_refuses_18():
    """The slot_grid kernel takes odd sub-grids and slots at any float
    address (a bulk copy for the 16-byte-aligned middle, plain loads for
    head and tail), 15^3 to 17^3 in two x-slabs per slot, and still
    refuses what shared memory cannot hold even in two slabs (18^3)."""
    u = T(random_slots(42, 2))
    kw = dict(h=0.01, h_slots=None, ghost=3, subgrid=8)
    n = u.numel()
    buf = torch.zeros(n + 4)
    for off in range(4):
        kern.check_kernel_args(buf[off:off + n].view(u.shape), **kw)
    for s in (5, 7):
        p = s + 6
        odd = torch.zeros((3, 5, p, p, p))
        kern.check_kernel_args(odd, h=0.01, h_slots=None, ghost=3,
                               subgrid=s)
        assert kern.smem_bytes(s) <= kern.SMEM_PER_BLOCK
    for s in (15, 16, 17):
        p = s + 6
        kern.check_kernel_args(torch.zeros((2, 5, p, p, p)), h=0.01,
                               h_slots=None, ghost=3, subgrid=s)
        plan = kern.slab_plan(s)
        assert plan.slabs == 2 and kern.ctas_per_slot(s) == 6
        assert plan.smem <= kern.SMEM_PER_BLOCK
    # 16^3: two slabs of 8 cells, ~181.6 KB per CTA (the whole slot would
    # need 300,016 B)
    assert kern.smem_bytes(16) == 181_616
    assert kern.slab_plan(14).slabs == 1
    with pytest.raises(NotImplementedError, match="shared memory"):
        kern.check_kernel_args(torch.zeros((1, 5, 24, 24, 24)), h=0.01,
                               h_slots=None, ghost=3, subgrid=18)


def _slot_copy(addr, nslot):
    """numpy mirror of csrc/hydro_rhs.cu's split of one slot at byte
    address ``addr`` (nslot floats): (floats before the first 16-byte
    boundary, bulk bytes, shared-memory offset of the slot in floats)."""
    head = ((16 - addr % 16) % 16) // 4
    bulk = (nslot - head) // 4 * 16
    return head, bulk, (4 - head) % 4


@pytest.mark.parametrize("s", [4, 5, 7, 8])
def test_kernel_slot_copy_covers_each_slot_once(s):
    """For every slot of a bucket at every float alignment of the tensor:
    head, bulk middle and tail cover the slot's floats once each; the bulk
    copy's global and shared addresses are 16-byte aligned and its size a
    multiple of 16; the slot stays below the face buffer in shared memory,
    all of it within ``smem_bytes``."""
    p = s + 6
    nslot = 5 * p ** 3
    for base in (0, 4, 8, 12):
        heads = set()
        for slot in range(5):
            addr = base + 4 * nslot * slot
            head, bulk, shift = _slot_copy(addr, nslot)
            heads.add(head)
            assert 0 <= head < 4 and bulk % 16 == 0 and bulk > 0
            assert (addr + 4 * head) % 16 == 0
            assert 4 * (shift + head) % 16 == 0
            tail = nslot - head - bulk // 4
            assert 0 <= tail < 4
            cover = np.zeros(nslot, int)
            cover[:head] += 1
            cover[head:head + bulk // 4] += 1
            cover[head + bulk // 4:] += 1
            assert (cover == 1).all()
            assert shift + nslot <= 4 + nslot       # below the face buffer
        # even S: every slot is aligned alike (5 P^3 floats, a multiple
        # of 4); odd S: the slots start at every float offset in turn
        assert len(heads) == (1 if s % 2 == 0 else 4)
        if base == 0 and s % 2 == 0:
            assert heads == {0}
    assert kern.smem_bytes(s) == 4 * (4 + nslot + 5 * (s + 1) * s * s)


def _coords(lin, p):
    return lin // (p * p), (lin // p) % p, lin % p


def test_kernel_quadrature_table_and_bounds():
    """The table the kernel keeps equals FACE_QUAD and DIR_PAIRS, and every
    sample it takes for a consumed face lies inside the padded block (so
    direct indexing equals the reference's roll)."""
    s, g = 8, 3
    p = s + 2 * g
    weights, table = kern._quad_table()
    t = np.asarray(table).reshape(3, 9, 8)
    w = np.asarray(weights).reshape(3, 9)
    lo, hi = p, -1
    for a in range(3):
        for q, (wq, pl, sl, pr, sr) in enumerate(flux.FACE_QUAD[a]):
            assert w[a, q] == np.float32(wq)
            assert (t[a, q, 3], t[a, q, 7]) == (sl, sr)
            for d, pair, shift in ((t[a, q, :3], pl, 0),
                                   (t[a, q, 4:7], pr, 1)):
                assert tuple(d) == tuple(ppm.DIR_PAIRS[pair])
                for x in range(s + (a == 0)):
                    for y in range(s + (a == 1)):
                        for z in range(s + (a == 2)):
                            c = np.array([g + x - (a == 0), g + y - (a == 1),
                                          g + z - (a == 2)])
                            c[a] += shift
                            for k in (-2, 2):
                                cc = c + k * d
                                lo, hi = min(lo, cc.min()), max(hi, cc.max())
    assert 0 <= lo and hi <= p - 1


def _face_flux(read, c, e, a, gamma, p):
    """numpy float32 mirror of hydro_common.cuh's face_flux: the weighted
    KNP flux of axis a's faces whose left cell sits at index c of the
    staged block (its right cell at c + e); ``read(idx)`` gives the staged
    values (n, F, len(idx)) at flat indices ``idx``, P x P planes."""
    weights, table = kern._quad_table()
    w = np.asarray(weights, np.float32).reshape(3, 9)
    t = np.asarray(table).reshape(3, 9, 8)
    strides = np.array([p * p, p, 1])
    f32 = np.float32

    def side(c, d, plus):
        um2, um1, u0, up1, up2 = (read(c + k * d) for k in range(-2, 3))
        ul = f32(7 / 12) * (um1 + u0) - f32(1 / 12) * (um2 + up1)
        ur = f32(7 / 12) * (u0 + up1) - f32(1 / 12) * (um1 + up2)
        ext = (ur - u0) * (u0 - ul) <= 0
        du, u6 = ur - ul, f32(6) * (u0 - f32(0.5) * (ul + ur))
        if plus:
            v = np.where(-(du * du) > du * u6, f32(3) * u0 - f32(2) * ul, ur)
        else:
            v = np.where(du * u6 > du * du, f32(3) * u0 - f32(2) * ur, ul)
        return np.where(ext, u0, v)

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

    acc = None
    for q in range(9):
        qL = side(c, t[a, q, :3] @ strides, t[a, q, 3])
        qR = side(c + e, t[a, q, 4:7] @ strides, t[a, q, 7])
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
                      + (ap * am) * inv * (qR - qL), f32(0.5) * (fL + fR))
        acc = w[a, q] * fl if acc is None else acc + w[a, q] * fl
    return acc


def _face_rows(a, nx, s, g, p):
    """The faces of axis a's grid over nx x-rows (axis_faces' order): face
    indices and the staged index of each face's left cell."""
    ny, nz = s + (a == 1), s + (a == 2)
    fi = np.arange(nx * ny * nz)
    z, y, x = fi % nz, (fi // nz) % ny, fi // (nz * ny)
    c = ((g + x - (a == 0)) * p * p + (g + y - (a == 1)) * p
         + (g + z - (a == 2)))
    return fi, c


def _emulate_kernel(u, h, gamma, s=8, g=3):
    """numpy float32 mirror of csrc/hydro_rhs.cu's face layout and index
    arithmetic over whole slots (one slab), vectorised over slots and
    faces."""
    n, nf, p = u.shape[0], u.shape[1], u.shape[2]
    flat = u.reshape(n, nf, p ** 3)
    out = None
    for a in range(3):
        ny, nz = s + (a == 1), s + (a == 2)
        _, c = _face_rows(a, s + (a == 0), s, g, p)
        acc = _face_flux(lambda idx: flat[:, :, idx], c, (p * p, p, 1)[a],
                         a, gamma, p)
        ci = np.arange(s ** 3)
        z, y, x = ci % s, (ci // s) % s, ci // (s * s)
        lo = (x * ny + y) * nz + z
        d = (acc[:, :, lo + (ny * nz, nz, 1)[a]] - acc[:, :, lo]) / np.float32(h)
        out = -d if out is None else out - d
    return out.reshape(n, nf, s, s, s)


def _head(addr):
    """Floats before the first 16-byte boundary at byte address addr."""
    return ((16 - addr % 16) % 16) // 4


def _emulate_slab_kernel(u, h, gamma, s, g=3, base=0):
    """numpy float32 replay of csrc/hydro_rhs.cu's x-slab scheme for slots
    starting at byte address ``base`` + slot offset: each CTA (slab j,
    axis a) stages its slab's runs (head and tail loads, the bulk middle)
    into its own shared memory laid out as the kernel lays it out, checks
    every staged float is written once and lies below the face buffer,
    evaluates its faces from the staged block alone (unstaged floats are
    NaN) into a buffer of the kernel's strides, and the divergence reads
    the faces where the kernel reads them, the next slab's face 0 for a
    slab's last cell.  Returns (n, F, S, S, S)."""
    n, nf, p = u.shape[0], u.shape[1], u.shape[2]
    plan = kern.slab_plan(s, g)
    # slab j's cells along x: [j S / k, (j + 1) S / k), as the kernel cuts
    starts = [j * s // plan.slabs for j in range(plan.slabs + 1)]
    smem = plan.smem // 4
    p2, p3 = p * p, p ** 3
    face_at = 4 + (nf - 1) * plan.field_stride + plan.span
    wmax = plan.width
    stride = ((wmax + 1) * s * s, wmax * (s + 1) * s, wmax * s * (s + 1))
    assert face_at + nf * max(stride) <= smem
    f32 = np.float32
    out = np.full((n, nf, s, s, s), np.nan, f32)
    for i in range(n):
        slot = u[i].reshape(-1)
        faces = {}
        for j in range(plan.slabs):
            x0, w = starts[j], starts[j + 1] - starts[j]
            src = base + 4 * (i * nf * p3 + x0 * p2)  # byte address
            runs = 1 if plan.slabs == 1 else nf
            run = nf * p3 if plan.slabs == 1 else (w + 2 * g) * p2
            us = (4 - _head(src)) % 4
            stage = np.full(smem, np.nan, f32)
            written = np.zeros(smem, int)
            for r in range(runs):
                addr = src + 4 * r * p3
                hd = _head(addr)
                bulk = (run - hd) // 4 * 16
                dst = us + r * plan.field_stride
                assert (addr + 4 * hd) % 16 == 0 and (4 * (dst + hd)) % 16 == 0
                seg = slot[r * p3 + x0 * p2:r * p3 + x0 * p2 + run]
                stage[dst:dst + run] = seg
                written[dst:dst + run] += 1
                assert 0 <= run - hd - bulk // 4 < 4
                assert dst + run <= face_at
            assert written.max() == 1

            def read(idx, stage=stage, us=us):
                return np.stack([stage[us + f * plan.field_stride + idx]
                                 for f in range(nf)])[None]

            for a in range(3):
                nx = w + (a == 0 and j == plan.slabs - 1)
                _, c = _face_rows(a, nx, s, g, p)
                acc = _face_flux(read, c, (p2, p, 1)[a], a, gamma, p)
                buf = np.full(nf * stride[a], np.nan, f32)
                for f in range(nf):
                    buf[f * stride[a]:f * stride[a] + len(c)] = acc[0, f]
                faces[(j, a)] = buf
        for j in range(plan.slabs):
            x0, w = starts[j], starts[j + 1] - starts[j]
            nx0 = w + (j == plan.slabs - 1)
            ci = np.arange(w * s * s)
            z, y, x = ci % s, (ci // s) % s, ci // (s * s)
            for f in range(nf):
                f0, f1, f2 = (faces[(j, a)][f * stride[a]:] for a in range(3))
                lo0 = x * s * s + y * s + z
                if j + 1 < plan.slabs:
                    nxt = faces[(j + 1, 0)][f * stride[0]:]
                    hi = np.where(x + 1 < nx0, f0[np.minimum(lo0 + s * s,
                                                             len(f0) - 1)],
                                  nxt[y * s + z])
                else:
                    hi = f0[lo0 + s * s]
                acc = -((hi - f0[lo0]) / f32(h))
                lo1 = (x * (s + 1) + y) * s + z
                acc = acc - (f1[lo1 + s] - f1[lo1]) / f32(h)
                lo2 = (x * s + y) * (s + 1) + z
                acc = acc - (f2[lo2 + 1] - f2[lo2]) / f32(h)
                out[i, f, x0:x0 + w] = acc.reshape(w, s, s)
    return out


def test_kernel_index_arithmetic_emulated_matches_plain(sedov_slots):
    """The kernel's face layout, quadrature table and divergence indexing,
    replayed in numpy, give the plain version's result."""
    u = np.concatenate([random_slots(50, 1), sedov_slots[3:4]])
    want = kern.hydro_rhs_plain(T(u), **KW).numpy()
    got = _emulate_kernel(u, KW["h"], KW["gamma"])
    np.testing.assert_allclose(got, want, **_tol(want))


@pytest.mark.parametrize("s,base", [(8, 0), (15, 0), (15, 4), (15, 8),
                                    (15, 12), (16, 0), (16, 4)])
def test_kernel_slabs_replayed_equal_whole_slot(s, base):
    """The x-slab scheme at 16^3 and 15^3 (and one slab at 8^3), replayed
    in numpy with the kernel's staging (every float of a slab's runs
    written once, each bulk middle 16-byte aligned in memory and in shared
    memory, at each float offset of the tensor), face ownership (a face
    between two slabs evaluated once, by the upper slab) and divergence
    indexing: equal to the whole-slot replay in every bit, and within the
    kernel tolerance of the plain version."""
    rng = np.random.default_rng(51)
    p = s + 6
    rho = 1.0 + 0.3 * rng.random((2, 1, p, p, p))
    vel = 0.2 * rng.standard_normal((2, 3, p, p, p))
    e = 2.0 + rng.random((2, 1, p, p, p))
    u = np.concatenate([rho, rho * vel, e], axis=1).astype(np.float32)
    if s == 16:
        cfg = CONFIG_16
        u[1] = state.extract_subgrids(
            state.sedov_init(cfg, device="cpu").u, 16, 3)[21].numpy()
    got = _emulate_slab_kernel(u, 0.01, 1.4, s, base=base)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, _emulate_kernel(u, 0.01, 1.4, s=s))
    want = kern.hydro_rhs_plain(T(u), h=0.01, gamma=1.4, ghost=3,
                                subgrid=s).numpy()
    np.testing.assert_allclose(got, want, **_tol(want))


# ---------------------------------------------------------------------------
# state: initial condition, decomposition, carrying a state across
# ---------------------------------------------------------------------------

def test_sedov_init_matches_reference():
    want = np.asarray(jstate.sedov_init(JCFG).u)
    got = state.sedov_init(CFG, device="cpu").u.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bc", ["outflow", "periodic"])
def test_extract_subgrids_matches_reference_and_round_trips(bc):
    u = np.random.default_rng(60).random((5, 16, 16, 16), dtype=np.float32)
    want = np.asarray(jstate.extract_subgrids(jnp.asarray(u), 8, 3, bc))
    subs = state.extract_subgrids(T(u), 8, 3, bc)
    np.testing.assert_array_equal(subs.numpy(), want)
    interior = subs[:, :, 3:-3, 3:-3, 3:-3]
    assert torch.equal(state.assemble_global(interior, 8), T(u))
    np.testing.assert_array_equal(
        state.assemble_global(interior, 8).numpy(),
        np.asarray(jstate.assemble_global(jnp.asarray(interior.numpy()), 8)))


def test_state_carries_across_exactly():
    u = np.asarray(jstate.sedov_init(JCFG).u)
    t = state.state_from_numpy(u, "cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(state.state_to_numpy(t), u)


def test_diagnostics_match_reference():
    ju = jstate.sedov_init(JCFG).u
    u = state.state_from_numpy(np.asarray(ju), "cpu")
    h = 1.0 / 16
    np.testing.assert_allclose(float(stepper.courant_dt(u, CFG)),
                               float(jstepper.courant_dt(ju, JCFG)),
                               rtol=1e-6)
    # sums run in another order than XLA's: a few float32 ulps of the total
    np.testing.assert_allclose(stepper.total_conserved(u, h).numpy(),
                               np.asarray(jstepper.total_conserved(ju, h)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(stepper.shock_radius(u, CFG)),
                               float(jstepper.shock_radius(ju, JCFG)),
                               rtol=1e-6)
