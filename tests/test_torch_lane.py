"""The port's slot_lane layout (tasks on the last axis) against the JAX
reference.

The same inputs, made with numpy from a seed, go through ``repro`` (on the
CPU, its Pallas lane kernel in interpret mode, or its jnp oracle at 16^3,
where interpret mode is too slow) and ``repro_torch``.  Kernel-level cases
use the reference's kernel tolerance (tests/test_kernels.py): ``rtol=2e-5``
and ``atol=2e-6 x max|want|`` of each slot and field.  Within the port a
slot's result does not depend on the bucket it was launched in, bit for bit
(the property the reference's lane kernel breaks in
``test_hydro_rhs_kernel_traced_h[slot_lane]``).  The CUDA kernel itself is
tested on the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import HydroConfig as JHydroConfig  # noqa: E402
from repro.hydro import state as jstate  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.hydro_rhs import hydro_rhs_pallas  # noqa: E402

from repro_torch.configs.base import HydroConfig  # noqa: E402
from repro_torch.kernels import hydro_rhs as kern  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

KW = dict(gamma=1.4, ghost=3, subgrid=8)
H = 0.01
H100_SMS = 132              # the SMs a lane plan covers on an H100
WIDTHS = np.array([0.02, 0.01, 0.02, 0.01], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def random_slots(seed, n, s=8, g=3):
    """Random smooth conserved states (n, 5, P, P, P) float32, as the
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
    """4 slots of 8^3: two random, two of the reference's Sedov IC at
    levels=1 (near-vacuum pressure, floors and the blast's jump)."""
    u = jstate.sedov_init(JHydroConfig(levels=1)).u
    sedov = np.asarray(jstate.extract_subgrids(u, 8, 3))
    return np.concatenate([random_slots(90, 2), sedov[2:4]])


def lane_major(u):
    return T(u).permute(1, 2, 3, 4, 0).contiguous()


def slot_major(x):
    return x.permute(4, 0, 1, 2, 3)


def widths(case, n):
    """(kwargs for the port, kwargs for the reference) of one width case."""
    if case == "static":
        return dict(h=H), dict(h=H)
    hs = np.resize(WIDTHS, n)
    return dict(h_slots=T(hs)), dict(h_slots=jnp.asarray(hs))


def assert_kernel_tol(got, want):
    """rtol 2e-5, atol 2e-6 x max|want| of each slot and field."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).reshape(want.shape[:2] + (-1,)).max(-1)
    atol = 2e-6 * scale.reshape(scale.shape + (1,) * (want.ndim - 2))
    excess = np.abs(got - want) - (atol + 2e-5 * np.abs(want))
    worst = np.unravel_index(np.argmax(excess), excess.shape)
    assert excess[worst] <= 0, (worst, got[worst], want[worst])


@pytest.mark.parametrize("case", ["static", "h_slots"])
def test_lane_plain_matches_reference_lane_kernel(slots, case):
    """The reference's Pallas slot_lane kernel (interpret mode, a 4-lane
    tile) and the port's plain lane body on the same lane-major input."""
    mine, theirs = widths(case, slots.shape[0])
    want = hydro_rhs_pallas(jnp.asarray(slots), layout="slot_lane",
                            lane_tile=4, interpret=True, **theirs, **KW)
    got = kern.hydro_rhs_lane_plain(lane_major(slots), **mine, **KW)
    assert got.shape == (5, 8, 8, 8, slots.shape[0])
    assert_kernel_tol(slot_major(got).numpy(), want)


def test_lane_plain_at_16_matches_reference_oracle():
    """S=16, the paper's second Table II sub-grid, against the reference's
    jnp oracle (its interpret-mode kernel is too slow at this size)."""
    kw = dict(KW, subgrid=16)
    u = random_slots(91, 2, s=16)
    want = jref.hydro_rhs_ref(jnp.asarray(u), h=H, **kw)
    got = kern.hydro_rhs_lane_plain(lane_major(u), h=H, **kw)
    assert got.shape == (5, 16, 16, 16, 2)
    assert_kernel_tol(slot_major(got).numpy(), want)


@pytest.mark.parametrize("case", ["static", "h_slots"])
def test_ops_lane_layout_matches_slot_grid(slots, case):
    """``ops.hydro_rhs`` keeps the reference's public shapes in both
    layouts; on the CPU the lane layout runs the plain lane body between
    two transposes, and launches nothing."""
    mine, _ = widths(case, slots.shape[0])
    u = T(slots)
    before = kern.hydro_rhs_lane_cuda.launches
    lane = ops.hydro_rhs(u, layout="slot_lane", **mine, **KW)
    grid = ops.hydro_rhs(u, layout="slot_grid", **mine, **KW)
    assert kern.hydro_rhs_lane_cuda.launches == before
    assert lane.shape == grid.shape == (4, 5, 8, 8, 8)
    assert lane.is_contiguous()
    assert_kernel_tol(lane.numpy(), grid.numpy())
    body = ops.level_batched_body(1.4, 3, 8, layout="slot_lane")
    assert body is ops.level_batched_body(1.4, 3, 8, layout="slot_lane")
    if case == "h_slots":
        assert torch.equal(body(u, mine["h_slots"]), lane)
    else:
        cfg = HydroConfig(levels=1)
        assert torch.equal(
            ops.hydro_batched_body(cfg, H, layout="slot_lane")(u), lane)


@pytest.mark.parametrize("case", ["static", "h_slots"])
def test_lane_slot_result_independent_of_bucket(slots, case):
    """Every slot of a whole-wave call equals that slot from buckets of 1
    and 3 (ragged tail included), in mixed-width batches too: bit for
    bit."""
    u = np.concatenate([slots, random_slots(92, 3)])
    n = u.shape[0]
    mine, _ = widths(case, n)
    whole = kern.hydro_rhs_lane_plain(lane_major(u), **mine, **KW)
    for size in (1, 3):
        for a in range(0, n, size):
            b = min(a + size, n)
            kw = ({"h_slots": mine["h_slots"][a:b].contiguous()}
                  if case == "h_slots" else mine)
            part = kern.hydro_rhs_lane_plain(lane_major(u[a:b]), **kw, **KW)
            assert torch.equal(part, whole[..., a:b]), (size, a)


def _lane_schedule(s, n, g=3):
    """Index replay of csrc/hydro_rhs_lane.cu's launch for n tasks of
    ``s``^3 (``kern.lane_plan``): for each tile (a cluster of 3 CTAs per
    lane group) and axis, the padded cell index c of each face CTA a
    evaluates and its local face index, checking that every shared-memory
    index [field][face][lane] lies within the CTA's bytes and that the
    three CTAs' shares of the tile's (cell, lane) pairs cover each pair
    once.  Returns (plan, tiles), tiles a list of (low cell, extent,
    per-axis face arrays (c, local index))."""
    plan = kern.lane_plan(s, n, H100_SMS)
    p = s + 2 * g
    lanes, smem_floats = kern.LANES, plan.smem // 4
    tiles = []
    for (x0, y0, z0), box in kern.lane_tiles(s, plan.tile):
        axes = []
        for a in range(3):
            ny, nz = box[1] + (a == 1), box[2] + (a == 2)
            nface = (box[0] + (a == 0)) * ny * nz
            fi = np.arange(nface)
            z, y, x = fi % nz, (fi // nz) % ny, fi // (nz * ny)
            c = ((g + x0 + x - (a == 0)) * p * p + (g + y0 + y - (a == 1)) * p
                 + (g + z0 + z - (a == 2)))
            # last field, last face, last lane of the CTA's buffer
            assert ((5 - 1) * nface + nface - 1) * lanes + lanes - 1 \
                < smem_floats
            axes.append((c, fi))
        items = box[0] * box[1] * box[2] * lanes
        share = -(-items // 3)
        owners = np.zeros(items, int)
        for rank in range(3):
            owners[rank * share:min(items, (rank + 1) * share)] += 1
        assert (owners == 1).all()
        tiles.append(((x0, y0, z0), box, axes))
    assert len(tiles) == plan.tiles
    return plan, tiles


def _emulate_lane_kernel(u_t, widths, gamma, s=8, g=3):
    """numpy float32 mirror of csrc/hydro_rhs_lane.cu: ``_lane_schedule``'s
    tiles, each axis' faces of a tile evaluated once into the tile's face
    buffer [field][face][lane] (lane-major flat offsets ((f P^3 + c) n +
    lane) for every stencil value), then each cell's divergence from the
    tile's three buffers in axis order.  Vectorised over faces and
    lanes."""
    f32 = np.float32
    nf, p, n = u_t.shape[0], u_t.shape[1], u_t.shape[-1]
    flat = u_t.reshape(-1)
    weights, table = kern._quad_table()
    w = np.asarray(weights, f32).reshape(3, 9)
    t = np.asarray(table).reshape(3, 9, 8)
    p2, p3 = p * p, p ** 3
    steps = np.array([p2, p, 1])
    fields = np.arange(nf)[:, None, None]
    lanes = np.arange(n)[None, None, :]
    hh = np.broadcast_to(np.asarray(widths, f32), (n,))

    def side(c, d, plus):
        um2, um1, u0, up1, up2 = (
            flat[(fields * p3 + c[None, :, None] + k * d) * n + lanes]
            for k in range(-2, 3))
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
        rho = np.maximum(q[0], f32(1e-10))
        vel = q[1:4] / rho
        ke = f32(0.5) * rho * (vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2)
        return rho, vel, np.maximum(f32(gamma - 1.0) * (q[4] - ke),
                                    f32(1e-12))

    def phys(q, vel, pr, a):
        f = q * vel[a]
        f[4] = (q[4] + pr) * vel[a]
        f[1 + a] += pr
        return f

    def face(c, a):
        e = steps[a]
        acc = None
        for q in range(9):
            qL = side(c, t[a, q, :3] @ steps, t[a, q, 3])
            qR = side(c + e, t[a, q, 4:7] @ steps, t[a, q, 7])
            (rL, vL, pL), (rR, vR, pR) = prim(qL), prim(qR)
            cL = np.sqrt(f32(gamma) * pL / rL)
            cR = np.sqrt(f32(gamma) * pR / rR)
            ap = np.maximum(np.maximum(vL[a] + cL, vR[a] + cR), 0)
            am = np.minimum(np.minimum(vL[a] - cL, vR[a] - cR), 0)
            fL, fR = phys(qL, vL, pL, a), phys(qR, vR, pR, a)
            span = ap - am
            ok = span > f32(1e-12)
            inv = np.where(ok, f32(1) / np.maximum(span, f32(1e-12)), 0)
            fl = np.where(ok, (ap * fL - am * fR) * inv
                          + (ap * am) * inv * (qR - qL),
                          f32(0.5) * (fL + fR))
            acc = w[a, q] * fl if acc is None else acc + w[a, q] * fl
        return acc                                    # (F, faces, lanes)

    _, tiles = _lane_schedule(s, n, g)
    buffers = []
    for a in range(3):
        # every tile's axis-a faces in one vectorised evaluation
        vals = face(np.concatenate([axes[a][0] for _, _, axes in tiles]), a)
        bounds = np.cumsum([0] + [len(axes[a][0]) for _, _, axes in tiles])
        buffers.append([vals[:, bounds[i]:bounds[i + 1]]
                        for i in range(len(tiles))])
    out = np.empty((nf, s ** 3, n), f32)
    for i, ((x0, y0, z0), box, _) in enumerate(tiles):
        ci = np.arange(box[0] * box[1] * box[2])
        z, y, x = ci % box[2], ci // box[2] % box[1], ci // (box[2] * box[1])
        acc = None
        for a in range(3):
            ny, nz = box[1] + (a == 1), box[2] + (a == 2)
            lo = (x * ny + y) * nz + z
            buf = buffers[a][i]
            d = (buf[:, lo + (ny * nz, nz, 1)[a]] - buf[:, lo]) / hh
            acc = -d if acc is None else acc - d
        out[:, ((x0 + x) * s + y0 + y) * s + z0 + z] = acc
    return out.reshape(nf, s, s, s, n)


@pytest.mark.parametrize("case", ["static", "h_slots"])
def test_lane_kernel_index_arithmetic_emulated_matches_plain(slots, case):
    """The lane kernel's offsets, tiles, face buffers and divergence,
    replayed in numpy, give the plain lane body's result."""
    mine, _ = widths(case, slots.shape[0])
    u_t = lane_major(slots)
    want = kern.hydro_rhs_lane_plain(u_t, **mine, **KW)
    got = _emulate_lane_kernel(
        u_t.numpy(), mine.get("h_slots", torch.tensor(H)).numpy(),
        KW["gamma"])
    assert_kernel_tol(np.moveaxis(got, -1, 0),
                      slot_major(want).numpy())


def test_lane_kernel_emulated_at_16_matches_plain():
    """S=16 through the same replay (4^3 tiles), against the plain lane
    body."""
    kw = dict(KW, subgrid=16)
    u_t = lane_major(random_slots(94, 2, s=16))
    want = kern.hydro_rhs_lane_plain(u_t, h=H, **kw)
    got = _emulate_lane_kernel(u_t.numpy(), np.float32(H), KW["gamma"],
                               s=16)
    assert_kernel_tol(np.moveaxis(got, -1, 0), slot_major(want).numpy())


@pytest.mark.parametrize("s,n", [(8, 32), (8, 64), (8, 512), (16, 32),
                                 (16, 64), (5, 32), (7, 512)])
def test_lane_plan_faces_tiles_and_shared_memory(s, n):
    """Each face the divergence consumes is evaluated by the tile that
    holds it, and a face on a boundary between two tiles along its axis
    by both: ``face_evals`` counts exactly that, against the 3 (S+1) S^2
    needed.  Every tile lies in the sub-grid, the tiles cover each cell
    once, and the CTA's face buffer fits the plan's shared memory."""
    plan, tiles = _lane_schedule(s, n)
    g, p = 3, s + 6
    covered = np.zeros((s, s, s), int)
    evals = [dict() for _ in range(3)]
    for (x0, y0, z0), box, axes in tiles:
        covered[x0:x0 + box[0], y0:y0 + box[1], z0:z0 + box[2]] += 1
        for a, (c, _) in enumerate(axes):
            for cc in c.tolist():
                evals[a][cc] = evals[a].get(cc, 0) + 1
    assert (covered == 1).all()
    boundary = [set(range(t, s, t)) for t in plan.tile]
    for a in range(3):
        # the consumed faces of axis a: cell k along a, k = -1 .. S-1
        for x in range(-(a == 0), s):
            for y in range(-(a == 1), s):
                for z in range(-(a == 2), s):
                    if (a != 0 and x < 0) or (a != 1 and y < 0) or \
                            (a != 2 and z < 0):
                        continue
                    k = (x, y, z)[a] + 1          # face index along a
                    c = (g + x) * p * p + (g + y) * p + g + z
                    assert evals[a].pop(c) == 1 + (k in boundary[a]), (a, k)
        assert not evals[a]                  # nothing else evaluated
    needed = 3 * (s + 1) * s * s
    assert plan.face_evals == needed + sum(
        s * s * len(b) for b in boundary)
    assert plan.smem <= kern.SMEM_PER_BLOCK


def test_lane_plan_fills_the_card_and_shares_faces():
    """A 32-task bucket covers the 132 SMs at S=8 and S=16; at 512 x 8^3
    and 64 x 16^3 the plan evaluates at most 1.25x the faces needed; shared
    memory stays within a block's limit; a warp reads whole 64-byte
    segments (16 lanes of 4 bytes)."""
    assert 4 * kern.LANES >= 64 and kern.LANE_THREADS % 32 == 0
    for s in (8, 16):
        plan = kern.lane_plan(s, 32, H100_SMS)
        assert plan.ctas >= H100_SMS
        assert plan.smem <= kern.SMEM_PER_BLOCK
    for s, n in ((8, 512), (16, 64)):
        plan = kern.lane_plan(s, n, H100_SMS)
        assert plan.face_evals <= 1.25 * 3 * (s + 1) * s * s
        assert plan.ctas >= H100_SMS
    # a 1-task and a 32-task bucket tile differently; the bits of a task do
    # not depend on its tile (tests/test_torch_cuda.py holds them equal)
    assert kern.lane_plan(8, 1, H100_SMS).tile != \
        kern.lane_plan(8, 32, H100_SMS).tile


def test_lane_wrapper_rejects_what_the_kernel_does_not_take():
    u_t = lane_major(random_slots(93, 2))
    chk = kern.check_lane_args
    before = kern.hydro_rhs_lane_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.hydro_rhs_lane_cuda(u_t, h=H, **KW)
    with pytest.raises(TypeError, match="float32"):
        chk(u_t.double(), H, None, 3, 8)
    with pytest.raises(ValueError, match="expected"):
        chk(T(random_slots(93, 2)), H, None, 3, 8)     # slot-major
    with pytest.raises(ValueError, match="expected"):
        chk(u_t[:4], H, None, 3, 8)
    with pytest.raises(ValueError, match="contiguous"):
        chk(u_t.transpose(1, 2), H, None, 3, 8)
    with pytest.raises(NotImplementedError, match="ghost=3"):
        chk(u_t, H, None, 2, 10)
    with pytest.raises(ValueError, match="exactly one"):
        chk(u_t, H, torch.ones(2), 3, 8)
    with pytest.raises(ValueError, match="h_slots"):
        chk(u_t, None, torch.ones(3), 3, 8)
    chk(u_t, None, torch.ones(2), 3, 8)
    # nothing of size P^3 is staged: 16^3 is taken, as the slot_grid
    # kernel takes it in two x-slabs per slot; 18^3 only the lane kernel
    u16 = torch.zeros((5, 22, 22, 22, 1))
    chk(u16, H, None, 3, 16)
    kern.check_kernel_args(slot_major(u16).contiguous(), H, None, 3, 16)
    u18 = torch.zeros((5, 24, 24, 24, 1))
    chk(u18, H, None, 3, 18)
    with pytest.raises(NotImplementedError, match="shared memory"):
        kern.check_kernel_args(slot_major(u18).contiguous(), H, None, 3, 18)
    with pytest.raises(ValueError, match="unknown layout"):
        ops.hydro_rhs(T(random_slots(93, 2)), h=H, layout="lanes", **KW)
    with pytest.raises(ValueError, match="unknown layout"):
        ops.level_batched_body(1.4, 3, 8, layout="lanes")
    with pytest.raises(ValueError, match="unknown layout"):
        ops.hydro_batched_body(HydroConfig(), H, layout="lanes")
    with pytest.raises(ValueError, match="expected"):
        ops.hydro_rhs(T(random_slots(93, 2))[0], h=H, layout="slot_lane",
                      **KW)
    assert kern.hydro_rhs_lane_cuda.launches == before
