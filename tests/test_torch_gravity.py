"""The port's gravity family and self-gravitating Sedov scenario against the
JAX reference.

The same inputs, made with numpy from a seed, go through ``repro`` (on the
CPU, its Pallas kernel in interpret mode) and ``repro_torch``.  Kernel-level
cases use the reference's kernel tolerance (tests/test_kernels.py):
``atol=2e-6*max|want|`` per slot and field, ``rtol=2e-5``.  Within the port
every strategy equals ``fused`` bit for bit.  The CUDA kernel itself is
tested on the card by tests/test_torch_cuda.py.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.configs.gravity import CONFIG_SMALL as JCFG  # noqa: E402
from repro.core import GravityScenario as JGravityScenario  # noqa: E402
from repro.core import StrategyRunner as JStrategyRunner  # noqa: E402
from repro.hydro import state as jstate  # noqa: E402
from repro.hydro import stepper as jstepper  # noqa: E402
from repro.kernels import gravity as jgrav  # noqa: E402

from repro_torch.configs.base import AggregationConfig  # noqa: E402
from repro_torch.configs.gravity import CONFIG, CONFIG_SMALL  # noqa: E402
from repro_torch.core import GravityScenario, StrategyRunner  # noqa: E402
from repro_torch.hydro.state import (  # noqa: E402
    extract_subgrids, sedov_init, state_from_numpy, state_to_numpy,
)
from repro_torch.hydro.stepper import courant_dt, total_conserved  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import gravity as grav  # noqa: E402
from repro_torch.kernels._build import SMEM_PER_BLOCK  # noqa: E402

CFG = CONFIG_SMALL
HC = CFG.hydro
KW = dict(ghost=HC.ghost, subgrid=HC.subgrid, g_const=CFG.g_const,
          n_iter=CFG.relax_iters)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def assert_kernel_tol(got, want):
    """rtol 2e-5, atol 2e-6 x max|want| of each slot and field."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).reshape(want.shape[:2] + (-1,)).max(-1)
    atol = 2e-6 * scale.reshape(scale.shape + (1,) * (want.ndim - 2))
    excess = np.abs(got - want) - (atol + 2e-5 * np.abs(want))
    worst = np.unravel_index(np.argmax(excess), excess.shape)
    assert excess[worst] <= 0, (worst, got[worst], want[worst])


def random_density_slots(seed, n, p=14):
    """Positive random densities in field 0 (the other fields random too:
    the solve must ignore them)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 5, p, p, p)).astype(np.float32)
    u[:, 0] = 0.5 + rng.random((n, p, p, p), dtype=np.float32)
    return u


@pytest.fixture(scope="module")
def sedov_slots():
    u = jstate.sedov_init(JCFG.hydro).u
    return np.asarray(jstate.extract_subgrids(u, HC.subgrid, HC.ghost))


@pytest.fixture(scope="module")
def mixed_case(sedov_slots):
    """8 Sedov slots and 4 random ones with mixed widths, through the
    reference's aggregation-region body."""
    u = np.concatenate([sedov_slots, random_density_slots(1, 4)])
    h = np.where(np.arange(u.shape[0]) % 2 == 0, 0.125, 0.0625
                 ).astype(np.float32)
    body = jgrav.gravity_batched_body(HC.ghost, HC.subgrid, CFG.g_const,
                                      CFG.relax_iters)
    return u, h, np.asarray(body(jnp.asarray(u), jnp.asarray(h)))


# ---------------------------------------------------------------------------
# the gravity body
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    assert (CFG.name, CFG.g_const, CFG.relax_iters) == (
        JCFG.name, JCFG.g_const, JCFG.relax_iters)
    assert CFG.hydro.n_subgrids == JCFG.hydro.n_subgrids == 8
    assert CONFIG.hydro.n_subgrids == 64


def test_gravity_batched_body_matches_reference(mixed_case):
    u, h, want = mixed_case
    body = grav.gravity_batched_body(HC.ghost, HC.subgrid, CFG.g_const,
                                     CFG.relax_iters)
    got = body(T(u), T(h)).numpy()
    assert got.shape == want.shape == (12, 4, 8, 8, 8)
    assert_kernel_tol(got, want)
    assert torch.equal(T(got), grav.gravity_plain(T(u), T(h), **KW))


@pytest.mark.parametrize("i", [0, 9])
def test_subgrid_gravity_one_task_matches_reference(i, mixed_case):
    u, h, want = mixed_case
    got = grav.subgrid_gravity(T(u[i]), float(h[i]), **KW).numpy()
    assert_kernel_tol(got[None], want[i:i + 1])


def test_gravity_plain_matches_pallas_interpret(sedov_slots):
    """Two slots through the Pallas kernel as the reference's tests run it
    on the CPU (interpret mode), with mixed widths, held to the tolerance
    tests/test_gravity.py holds that kernel to: atol 2e-6 x max(max|want|,
    1) over the batch, rtol 2e-5.  Interpret mode compiles another program
    than the jnp body, and a gradient of a nearly flat potential cancels,
    so the per-slot-and-field scale is too tight for it (the jnp body is
    held to that scale above)."""
    u = np.concatenate([sedov_slots[:1], random_density_slots(2, 1)])
    h = np.array([0.125, 0.0625], np.float32)
    want = np.asarray(jgrav.gravity_pallas(jnp.asarray(u), jnp.asarray(h),
                                           interpret=True, **KW))
    got = grav.gravity_plain(T(u), T(h), **KW).numpy()
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, atol=2e-6 * max(scale, 1.0),
                               rtol=2e-5)


@pytest.mark.parametrize("with_scale", [False, True])
def test_gravity_source_update_matches_reference(with_scale):
    rng = np.random.default_rng(3)
    u, dudt = (rng.standard_normal((5, 8, 8, 8)).astype(np.float32)
               for _ in range(2))
    pg = rng.standard_normal((4, 8, 8, 8)).astype(np.float32)
    scale = np.float32(0.37) if with_scale else None
    want = np.asarray(jgrav.gravity_source_update(
        jnp.asarray(u), jnp.asarray(dudt), jnp.asarray(pg),
        None if scale is None else jnp.float32(scale)))
    got = grav.gravity_source_update(
        T(u), T(dudt), T(pg), None if scale is None else float(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0].numpy(), dudt[0])


def test_zero_density_zero_field():
    p = HC.padded
    out = grav.subgrid_gravity(torch.zeros((5, p, p, p)), 0.1, **KW)
    assert out.shape == (4, 8, 8, 8)
    assert not bool(out.any())


def _kernel_constants(source):
    """The ``constexpr int kName = N;`` constants compiled into
    ``csrc/<source>``, so the replays follow the kernel's own values."""
    text = (_build.CSRC / source).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


CU = _kernel_constants("gravity.cu")
THREADS = CU["kThreads"]
INSTANCES = (CU["kCellsSmall"], CU["kCellsLarge"])


def _cells_per_thread(p):
    """The instance ``csrc/gravity.cu::gravity_launch`` takes at padded
    width p: the smaller whose cells per thread cover the (p - 2)^3 cells
    off the frame, or 0 where neither does."""
    need = -(-(p - 2) ** 3 // THREADS)
    return next((k for k in INSTANCES if k >= need), 0)


def _block_replay(u, h, *, ghost, subgrid, g_const, n_iter):
    """numpy float32 replay of csrc/gravity.cu's schedule for each slot's
    block: thread t owns the cells t, t + THREADS, ... (at most
    ``_cells_per_thread`` of them) off the frame, x slowest; a ping-pong pair
    of (P, P, P) arrays zeroed once; the first sweep reads no neighbours
    (phi = 0: the reference's sum of six zeros is +0); each later sweep
    reads one array and writes the other, with one barrier between.
    Checks on the way that every cell is owned once and that no thread owns
    more cells than the kernel instance the launch picks."""
    n, p = u.shape[0], u.shape[-1]
    s, g, m = subgrid, ghost, p - 2
    f32 = np.float32
    c = f32(4.0 * np.pi * g_const)
    j = np.arange(m ** 3)
    k = j // THREADS
    assert k.max() < _cells_per_thread(p)
    x, y, z = 1 + j // (m * m), 1 + (j // m) % m, 1 + j % m
    owned = np.zeros((p, p, p), int)
    np.add.at(owned, (x, y, z), 1)
    assert (owned[1:-1, 1:-1, 1:-1] == 1).all() and owned.sum() == m ** 3
    assert 2 * 4 * p ** 3 <= SMEM_PER_BLOCK
    rhs = (c * u[:, 0]) * (h * h)[:, None, None, None]
    bufs = np.zeros((2, n, p, p, p), f32)
    cur = 0
    for it in range(n_iter):
        if it == 0:
            nb = f32(0)
        else:
            phi = bufs[cur]
            nb = (phi[:, x - 1, y, z] + phi[:, x + 1, y, z]
                  + phi[:, x, y - 1, z] + phi[:, x, y + 1, z]
                  + phi[:, x, y, z - 1] + phi[:, x, y, z + 1])
        bufs[cur ^ 1][:, x, y, z] = (nb - rhs[:, x, y, z]) / f32(6)
        cur ^= 1
    phi = bufs[cur]
    inv2h = (f32(0.5) / h)[:, None, None, None]
    ks, lo, hi = (slice(g, g + s), slice(g - 1, g - 1 + s),
                  slice(g + 1, g + 1 + s))
    return np.stack([phi[:, ks, ks, ks],
                     (phi[:, lo, ks, ks] - phi[:, hi, ks, ks]) * inv2h,
                     (phi[:, ks, lo, ks] - phi[:, ks, hi, ks]) * inv2h,
                     (phi[:, ks, ks, lo] - phi[:, ks, ks, hi]) * inv2h],
                    axis=1)


def test_kernel_replay_matches_plain(mixed_case):
    """The numpy float32 replay of csrc/gravity.cu's schedule (cells per
    thread, the first sweep without neighbours, ping-pong arrays with one
    barrier per sweep, the gradient)
    gives the plain version's result bit for bit: no index of an interior
    cell's stencil leaves [0, P-1], so the roll's wrap-around is never
    read."""
    u, h, _ = mixed_case
    np.testing.assert_array_equal(_block_replay(u, h, **KW),
                                  grav.gravity_plain(T(u), T(h),
                                                     **KW).numpy())


@pytest.mark.parametrize("s,g", [(5, 3), (16, 3), (1, 1), (2, 1)])
def test_kernel_replay_matches_plain_other_sizes(s, g):
    """The same replay at odd and 16^3 sub-grids and at the smallest (P = 3,
    4), with widths 2h, h, after 0, 1, 2 and 8 sweeps."""
    u = random_density_slots(6, 2, p=s + 2 * g)
    h = np.array([0.125, 0.0625], np.float32)
    kw = dict(KW, ghost=g, subgrid=s)
    for n_iter in (0, 1, 2, 8):
        kw["n_iter"] = n_iter
        np.testing.assert_array_equal(
            _block_replay(u, h, **kw),
            grav.gravity_plain(T(u), T(h), **kw).numpy())


@pytest.mark.parametrize("s,g", [(8, 3), (5, 3), (16, 3), (10, 3), (21, 3),
                                 (1, 1)])
def test_block_owns_each_cell_once(s, g):
    """Each cell off the frame belongs to exactly one thread of the slot's
    block (cells tid, tid + THREADS, ...), the launch picks the least
    instance that covers every thread's cells, and the block's shared
    memory fits."""
    p = s + 2 * g
    m = p - 2
    j = np.arange(m ** 3)
    owned = np.zeros((p, p, p), int)
    np.add.at(owned, (1 + j // (m * m), 1 + (j // m) % m, 1 + j % m), 1)
    assert (owned[1:-1, 1:-1, 1:-1] == 1).all() and owned.sum() == m ** 3
    per_thread = np.bincount(j % THREADS)
    assert _cells_per_thread(p) == min(k for k in INSTANCES
                                       if k >= per_thread.max())
    assert p <= grav.KERNEL_MAX_PADDED
    assert 2 * 4 * p ** 3 <= SMEM_PER_BLOCK


def test_ops_dispatches_cpu_tensors_to_plain():
    u, h = T(random_density_slots(4, 2)), torch.full((2,), 0.1)
    before = grav.gravity_cuda.launches
    assert torch.equal(ops.gravity(u, h, **KW),
                       grav.gravity_plain(u, h, **KW))
    assert grav.gravity_cuda.launches == before


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    u, h = T(random_density_slots(5, 2)), torch.full((2,), 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        grav.gravity_cuda(u, h, **KW)
    chk = grav.check_kernel_args
    with pytest.raises(NotImplementedError, match="ghost >= 1"):
        chk(u, h, ghost=0, subgrid=12, n_iter=8)
    with pytest.raises(NotImplementedError, match="shared memory"):
        chk(torch.zeros((1, 5, 32, 32, 32)), h[:1], ghost=3, subgrid=26,
            n_iter=8)
    # P = 28: 26^3 cells, 18 per thread
    with pytest.raises(NotImplementedError, match="registers"):
        chk(torch.zeros((1, 5, 28, 28, 28)), h[:1], ghost=3, subgrid=22,
            n_iter=8)
    # P = 27, the largest the kernel takes: 16 cells per thread
    chk(torch.zeros((1, 5, 27, 27, 27)), h[:1], ghost=3, subgrid=21,
        n_iter=8)
    with pytest.raises(TypeError, match="float32"):
        chk(u.double(), h, ghost=3, subgrid=8, n_iter=8)
    with pytest.raises(ValueError, match="expected"):
        chk(u[:, :4], h, ghost=3, subgrid=8, n_iter=8)
    with pytest.raises(ValueError, match="contiguous"):
        chk(u.transpose(2, 3), h, ghost=3, subgrid=8, n_iter=8)
    with pytest.raises(ValueError, match="h_slots"):
        chk(u, h[:1], ghost=3, subgrid=8, n_iter=8)
    with pytest.raises(ValueError, match="h_slots"):
        chk(u, h.double(), ghost=3, subgrid=8, n_iter=8)
    with pytest.raises(ValueError, match="n_iter"):
        chk(u, h, ghost=3, subgrid=8, n_iter=-1)
    chk(u, h, ghost=3, subgrid=8, n_iter=8)
    # a bucket staged by index_select or narrow passes the checks
    chk(u.index_select(0, torch.tensor([1, 0])), h.narrow(0, 0, 2),
        ghost=3, subgrid=8, n_iter=8)
    # 2 and 16 cells per thread at 8^3 and 16^3; the wrapper's limit is
    # where the kernel's larger instance runs out, and its two phi arrays
    # fit shared memory there
    top = grav.KERNEL_MAX_PADDED
    assert (_cells_per_thread(14), _cells_per_thread(22)) == (2, 16)
    assert _cells_per_thread(top) > 0 == _cells_per_thread(top + 1)
    assert 2 * 4 * top ** 3 <= SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# the scenario: two families through one executor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_fused():
    u0 = sedov_init(HC, device="cpu").u
    dt = courant_dt(u0, HC)
    runner = StrategyRunner(GravityScenario(CFG),
                            AggregationConfig(strategy="fused"), device="cpu")
    return u0, dt, runner.rk3_step(u0, dt), runner


def test_fused_launches_both_families(port_fused):
    _, _, out, runner = port_fused
    assert runner.stats["kernel_launches"] == 6
    assert runner.launches_by_family == {}      # fused bypasses the pool
    assert bool(torch.isfinite(out).all()) and bool((out[0] > 0).all())


@pytest.mark.parametrize("strategy,n_exec", [("s3", 1), ("s2+s3", 2)])
def test_two_families_one_executor_equal_fused(port_fused, strategy,
                                               n_exec):
    """The port's counterpart of tests/test_gravity.py: hydro and gravity
    tasks interleave through one executor as two TaskSignature families,
    and the step equals fused bit for bit."""
    u0, dt, ref, _ = port_fused
    r = StrategyRunner(GravityScenario(CFG), AggregationConfig(
        strategy=strategy, n_executors=n_exec, max_aggregated=16),
        device="cpu")
    r.warmup()
    out = r.rk3_step(u0, dt)
    assert torch.equal(out, ref)
    hists = {k: v["aggregated_hist"] for k, v in r.stats["regions"].items()}
    assert hists == {"hydro_rhs[5x14x14x14,scalar]": {8: 3},
                     "gravity[5x14x14x14,scalar]": {8: 3}}
    assert r.launches_by_family == {"hydro_rhs": 3, "gravity": 3}
    assert r.stats["kernel_launches"] == 6


def test_small_buckets_equal_fused(port_fused):
    """Cap 4 splits each family's wave into two launches per stage; each
    slot's result does not depend on its bucket."""
    u0, dt, ref, _ = port_fused
    r = StrategyRunner(GravityScenario(CFG), AggregationConfig(
        strategy="s2+s3", n_executors=2, max_aggregated=4), device="cpu")
    assert torch.equal(r.rk3_step(u0, dt), ref)
    assert r.launches_by_family == {"hydro_rhs": 6, "gravity": 6}


def test_gravity_coupling_is_live(port_fused):
    """The gravity source moves the step away from the hydro-only one."""
    from repro_torch.core import UniformSedovScenario
    u0, dt, ref, _ = port_fused
    hydro_only = StrategyRunner(UniformSedovScenario(HC), AggregationConfig(
        strategy="fused"), device="cpu").rk3_step(u0, dt)
    assert not torch.equal(ref, hydro_only)
    # energy is not conserved (the source adds S.g, the potential energy
    # is not counted), and mass leaves through the outflow boundary, where
    # each sub-grid's own field is not zero: a small drift in mass only
    h = HC.domain / u0.shape[-1]
    c0, c1 = total_conserved(u0, h), total_conserved(ref, h)
    assert abs(float((c1[0] - c0[0]) / c0[0])) < 1e-5


def test_step_matches_reference():
    """A JAX Sedov state carried across, stepped by the port's s3 runner,
    is allclose to the reference's fused runner over the same dt.  One RK3
    step compounds the per-stage kernel tolerance over 3 stages:
    rtol 1e-5, atol 1e-6 x max|want|, as for the uniform path."""
    ju = jstate.sedov_init(JCFG.hydro).u
    jdt = jstepper.courant_dt(ju, JCFG.hydro)
    want = np.asarray(JStrategyRunner(
        JGravityScenario(JCFG),
        JAggregationConfig(strategy="fused")).rk3_step(ju, jdt))
    u = state_from_numpy(np.asarray(ju), "cpu")
    r = StrategyRunner(GravityScenario(CFG), AggregationConfig(
        strategy="s3", max_aggregated=4), device="cpu")
    got = state_to_numpy(r.rk3_step(u, torch.tensor(float(jdt))))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StrategyRunner(GravityScenario(CFG), AggregationConfig())


def test_scenario_parents_are_shared():
    """Both families read the same two parents: one sub-grid tensor and one
    (n,) width tensor, made once per device."""
    sc = GravityScenario(CFG)
    u0 = sedov_init(HC, device="cpu").u
    hyd, gra = sc.populations(u0)
    assert (hyd.kernel, gra.kernel) == ("hydro_rhs", "gravity")
    (subs, h), (subs_g, h_g) = hyd.parents, gra.parents
    assert subs is subs_g and h is h_g
    assert sc.populations(u0)[0].parents[1] is h
    assert torch.equal(subs, extract_subgrids(u0, 8, 3))
    assert h.shape == (8,) and h.dtype == torch.float32
    assert [k for k, _ in sc.warmup_parent_specs()] == ["hydro_rhs",
                                                        "gravity"]
