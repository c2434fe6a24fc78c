"""The port's sharded aggregation and multi-tenant batching (DESIGN.md §15)
against the JAX reference, on the CPU.

One counterpart of each test of ``tests/test_sharding.py``: the
``subgrid_mesh`` axes and its refusals (the reference's messages), the
executor reproduces the body, a whole range comes back with no copy,
``s4`` equals ``s3`` and ``mixed`` bit for bit, the stats report the
mesh, the batcher's tenants equal their solo runs bit for bit (uniform
and AMR, staged and eager), ``healthz`` merges a batcher's tenants, and
the backend key carries the device count.  The reference's eight-device
child runs here on ``subgrid_mesh(8, devices=["cpu"] * 8)``: eight shards
on one device (its own test is one of the reference's known failures,
so the port is held to the JAX one-device results instead).  A mesh over
two devices, ``cpu:0`` and ``cpu:1`` (distinct devices to the executor,
one memory), drives the several-device drain: per-device programs, the
inputs scattered and the shards gathered in shard order.  Then the port
held to the reference: after one step the tenants are within the kernel
tolerance of the JAX ``TenantBatcher``'s, its ``queue_depths`` and
``stats`` are equal, and the guard fails the same tasks with the same
counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.configs.base import HydroConfig as JHydroConfig  # noqa: E402
from repro.core import ShardedAggregationExecutor as JShardedExecutor  # noqa: E402
from repro.core import TenantBatcher as JTenantBatcher  # noqa: E402
from repro.core import UniformSedovScenario as JUniformSedovScenario  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.hydro.state import sedov_init as jsedov_init  # noqa: E402
from repro.hydro.stepper import courant_dt as jcourant_dt  # noqa: E402
from repro.core import StrategyRunner as JStrategyRunner  # noqa: E402
from repro.distributed.api import subgrid_mesh as jsubgrid_mesh  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.amr_sedov import CONFIG as AMR_CONFIG  # noqa: E402
from repro_torch.configs.base import AggregationConfig, HydroConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AMRSedovScenario, ShardedAggregationExecutor, StrategyRunner,
    TaskFailedError, TaskPopulation, TenantBatcher, UniformSedovScenario,
)
from repro_torch.core.aggregation import _backend_key, gather_futures  # noqa: E402
from repro_torch.core.faults import FaultInjector, FaultSpec  # noqa: E402
from repro_torch.core.strategies import get_strategy_class  # noqa: E402
from repro_torch.core.tunestore import entry_key  # noqa: E402
from repro_torch.hydro.state import amr_sedov_init, sedov_init  # noqa: E402
from repro_torch.distributed.api import subgrid_mesh  # noqa: E402
from repro_torch.hydro.stepper import (  # noqa: E402
    amr_courant_dt, amr_reference_step, courant_dt,
)
from repro_torch.models import model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

CPU = torch.device("cpu")
WM = 10 ** 9
CFG = HydroConfig(subgrid=8, ghost=3, levels=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sedov():
    u = sedov_init(CFG, device="cpu").u
    return u, courant_dt(u, CFG)


@pytest.fixture(scope="module")
def solo(sedov):
    """One RK3 step of the main path under ``s3``."""
    u, dt = sedov
    return StrategyRunner(UniformSedovScenario(CFG), _agg(strategy="s3"),
                          device="cpu").rk3_step(u, dt)


def _agg(**kw):
    kw.setdefault("strategy", "s4")
    kw.setdefault("launch_watermark", WM)
    return AggregationConfig(**kw)


def _exe(**kw):
    return ShardedAggregationExecutor(config=_agg(**kw), name="tenancy",
                                      device="cpu")


# ---------------------------------------------------------------------------
# executor drain: exactness and zero copy
# ---------------------------------------------------------------------------

def test_sharded_executor_matches_batched_fn():
    def body(x, y, out=None):
        r = x * 2.0 + torch.sin(y)
        return r if out is None else out.copy_(r)

    exe = ShardedAggregationExecutor(body, config=_agg(max_aggregated=4),
                                     name="toy", device="cpu")
    xs = torch.arange(24.0).reshape(12, 2)
    ys = torch.linspace(0.0, 1.0, 24).reshape(12, 2)
    fut = exe.submit_range((xs, ys), 2, 7)
    singles = [exe.submit(xs[i], ys[i]) for i in (0, 11)]
    exe.flush()
    assert torch.equal(fut.result(), body(xs[2:9], ys[2:9]))
    for f, i in zip(singles, (0, 11)):
        assert torch.equal(f.result(), body(xs[i:i + 1], ys[i:i + 1])[0])
    (region,) = (r for r in exe.stats["regions"].values()
                 if r["submitted"] == 9)
    # 7 tasks then 2 singles under the ladder (1, 2, 4): 4 + 2 + 1 and 2
    assert region["aggregated_hist"] == {4: 1, 2: 2, 1: 1}
    assert region["launches"] == 4 and region["sharded_launches"] == 2
    assert exe.pool.launches_by_family == {"toy": 4}


def test_range_future_full_wave_is_zero_copy():
    exe = ShardedAggregationExecutor(
        lambda x, out=None: torch.add(x, 1.0, out=out), config=_agg(),
        name="zc", device="cpu")
    n = 8
    xs = torch.arange(float(n * 3)).reshape(n, 3)
    fut = exe.submit_range((xs,), 0, n)
    exe.flush()
    assert fut.ready() and not fut.failed()
    assert len(fut._parts) == 1
    off, batch, slot, cnt = fut._parts[0]
    assert (off, slot, cnt) == (0, 0, n)
    out = fut.result()
    assert out is batch
    assert gather_futures([fut]) is out
    assert exe.ghost_gather(out) is out
    assert exe.halo_exchange(out) is out


def test_host_staging_and_multi_card_meshes_refused():
    with pytest.raises(ValueError, match="staging='device'"):
        _exe(staging="host")
    # the reference's refusal of a mesh larger than the visible devices
    with pytest.raises(ValueError, match=r"n_devices=2 outside 1\.\.1"):
        _exe(shard_devices=2)
    with pytest.raises(ValueError, match=r"outside 1\.\.1"):
        StrategyRunner(UniformSedovScenario(CFG), _agg(shard_devices=2),
                       device="cpu")
    assert _exe(shard_devices=1).n_shards == 1


# ---------------------------------------------------------------------------
# s4: bit identity with the single-card strategies
# ---------------------------------------------------------------------------

def test_s4_step_bit_identical_to_s3_and_mixed(sedov, solo):
    u, dt = sedov
    for name in ("s4", "sharded"):
        assert get_strategy_class(name).executor_cls is \
            ShardedAggregationExecutor
    out = StrategyRunner(UniformSedovScenario(CFG), _agg(),
                         device="cpu").rk3_step(u, dt)
    mixed = StrategyRunner(UniformSedovScenario(CFG), _agg(strategy="mixed"),
                           device="cpu").rk3_step(u, dt)
    assert torch.equal(out, solo)
    assert torch.equal(out, mixed)


def test_s4_executor_stats_report_mesh(sedov):
    u, dt = sedov
    r = StrategyRunner(UniformSedovScenario(CFG), _agg(), device="cpu")
    r.warmup()
    r.rk3_step(u, dt)
    stats = r.executor.stats
    assert stats["mesh"] == {"pod": 1, "data": 1}
    assert stats["n_shards"] == 1
    assert stats["launches"] >= 3
    assert stats["shard_occupancy"] == [CFG.n_subgrids]
    assert stats["backend_key"] == ("cpu", "cpu", "d1")
    assert r.executor.breaker_states() == {"hydro_rhs": "closed"}
    assert r.save_tuning() is None
    # each wave is the greedy decomposition (8 tasks: one bucket of 8)
    assert r.stats["kernel_launches"] == 3
    assert r.launches_by_family == {"hydro_rhs": 4}   # warmup's and 3


# ---------------------------------------------------------------------------
# multi-tenant batching
# ---------------------------------------------------------------------------

def test_tenant_batcher_bit_identical_to_solo_runs(sedov, solo):
    u, dt = sedov
    exe = _exe()
    tb = TenantBatcher(exe)
    for tid in ("a", "b", "c"):
        tb.add(tid, UniformSedovScenario(CFG), u, dt)
    assert tb.queue_depths() == {t: CFG.n_subgrids for t in ("a", "b", "c")}
    merged = tb.rk3_step_all()
    for tid in ("a", "b", "c"):
        assert torch.equal(merged[tid], solo)
    assert tb.stats["waves"] == 3
    assert tb.stats["max_tenancy"] == 3
    assert tb.stats["merged_tasks"] == 3 * 3 * CFG.n_subgrids
    assert not tb._eager and tb._stage_cache
    assert tb.stats["eager_fallbacks"] == 0
    # one range, one launch of 24 tasks (cap 32: buckets 16 and 8), per
    # stage, whatever the tenant count
    assert exe.stats["aggregated_hist"] == {16: 3, 8: 3}
    h = tb.healthz()
    assert h["count"] == 3
    assert h["shard_occupancy"] == [3 * CFG.n_subgrids]
    with pytest.raises(ValueError, match="already registered"):
        tb.add("a", UniformSedovScenario(CFG), u, dt)
    assert torch.equal(tb.remove("c"), solo) and len(tb) == 2


class _WithEmptyPopulation(UniformSedovScenario):
    """The main path's scenario with a second, zero-task population."""

    def populations(self, state, buffers=None):
        (pop,) = super().populations(state, buffers=buffers)
        return pop, TaskPopulation("hydro_rhs", (pop.parents[0][:0],))

    def assemble(self, state, outs):
        assert outs[1].shape == (0, 5, 8, 8, 8)
        return super().assemble(state, outs[:1])


@pytest.mark.parametrize("eager", [False, True])
def test_zero_task_population_gets_an_empty_output(sedov, solo, eager):
    u, dt = sedov
    tb = TenantBatcher(_exe())
    tb._eager = eager
    for tid in ("a", "b"):
        tb.add(tid, _WithEmptyPopulation(CFG), u, dt)
    merged = tb.rk3_step_all()
    for tid in ("a", "b"):
        assert torch.equal(merged[tid], solo)
    assert tb.stats["merged_tasks"] == 3 * 2 * CFG.n_subgrids


def test_tenants_of_other_widths_refused(sedov):
    """Tenants merge by kernel family: a tenant whose body differs (here
    another cell width at the same shapes) cannot share the family."""
    u, dt = sedov
    tb = TenantBatcher(_exe())
    tb.add("a", UniformSedovScenario(CFG), u, dt)
    with pytest.raises(ValueError, match="different body"):
        tb.add("b", UniformSedovScenario(
            HydroConfig(subgrid=8, ghost=3, levels=1, domain=2.0)), u, dt)


@pytest.fixture(scope="module")
def amr():
    st = amr_sedov_init(AMR_CONFIG, device="cpu")
    state = (st.uc, st.uf)
    dt = float(amr_courant_dt(st.uc, st.uf, AMR_CONFIG))
    solo = StrategyRunner(AMRSedovScenario(AMR_CONFIG), _agg(),
                          device="cpu").rk3_step(state, dt)
    return state, dt, solo


@pytest.mark.parametrize("eager", [False, True])
def test_tenant_batcher_staged_and_eager_match_solo_on_amr(amr, eager):
    """Populations that do real arithmetic (restriction, prolongation):
    the staged closures and the eager path both equal the solo runner."""
    state, dt, solo = amr
    tb = TenantBatcher(_exe())
    tb._eager = eager
    for tid in ("a", "b"):
        tb.add(tid, AMRSedovScenario(AMR_CONFIG), state, dt)
    merged = tb.rk3_step_all()
    assert bool(tb._stage_cache) is not eager
    assert tb.stats["waves"] == 3 and tb.stats["eager_fallbacks"] == 0
    for tid in ("a", "b"):
        for lvl in (0, 1):
            assert torch.equal(merged[tid][lvl], solo[lvl])


def test_serving_engine_healthz_reports_tenants(sedov):
    u, dt = sedov
    exe = _exe()
    tb = TenantBatcher(exe)
    tb.add("acme", UniformSedovScenario(CFG), u, dt)
    cfg = reduced(get_config("granite-8b"))
    m = model.init_params(cfg, 0, device="cpu")
    eng = ServingEngine(cfg, m, max_batch=2, max_len=32, batcher=tb,
                        device="cpu")
    eng.submit(Request(0, [3, 5], max_new_tokens=1, tenant="acme"))
    eng.submit(Request(1, [2], max_new_tokens=1, tenant="zeta"))
    t = eng.healthz()["tenants"]
    assert t["count"] == 2
    assert t["queue_depth"]["acme"] == 1 + CFG.n_subgrids
    assert t["queue_depth"]["zeta"] == 1
    assert t["shard_occupancy"] == [0] * exe.n_shards


def test_backend_key_carries_device_topology():
    key = _backend_key(CPU)
    assert key == ("cpu", "cpu", "d1")
    assert entry_key(key, "hydro") == "|".join((*key, "hydro"))
    other = (*key[:2], "d999")
    assert entry_key(other, "hydro") != entry_key(key, "hydro")


# ---------------------------------------------------------------------------
# the port held to the reference
# ---------------------------------------------------------------------------

def test_tenants_match_the_reference_batcher():
    """Two tenants through both batchers: after one step each tenant is
    within the kernel tolerance of the reference's, and the batchers'
    queue depths and stats agree."""
    jcfg = JHydroConfig(subgrid=8, ghost=3, levels=1)
    jst = jsedov_init(jcfg)
    jdt = jcourant_dt(jst.u, jcfg)
    jexe = JShardedExecutor(config=JAggregationConfig(
        strategy="s4", launch_watermark=WM), name="tenancy")
    jtb = JTenantBatcher(jexe)
    u = torch.from_numpy(np.array(jst.u))
    dt = float(jdt)
    tb = TenantBatcher(_exe())
    for tid in ("a", "b"):
        jtb.add(tid, JUniformSedovScenario(jcfg), jst.u, jdt)
        tb.add(tid, UniformSedovScenario(CFG), u, dt)
    assert tb.queue_depths() == jtb.queue_depths()
    jout = jtb.rk3_step_all()
    out = tb.rk3_step_all()
    for tid in ("a", "b"):
        w = np.asarray(jout[tid])
        g = out[tid].numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))
    assert {k: tb.stats[k] for k in jtb.stats} == jtb.stats
    assert tb.healthz()["count"] == jtb.healthz()["count"]
    assert tb.shard_occupancy() == jtb.shard_occupancy()


def test_guard_fails_the_reference_tasks():
    """Payload faults on tasks 2 and 5 under ``guard="finite"``: the same
    tasks fail with the same counters as the reference executor's, and
    the survivors are exact."""
    specs = [dict(site="payload", task=2), dict(site="payload", task=5,
                                                mode="inf")]
    jexe = JShardedExecutor(jax.vmap(lambda x: x * 2.0 + 1.0),
                            config=JAggregationConfig(
                                strategy="s4", guard="finite",
                                max_aggregated=4, launch_watermark=WM),
                            name="g", fault_injector=jfaults.FaultInjector(
                                [jfaults.FaultSpec(**d) for d in specs]))
    exe = ShardedAggregationExecutor(
        lambda x, out=None: torch.add(x * 2.0, 1.0, out=out),
        config=_agg(guard="finite", max_aggregated=4), name="g",
        device="cpu", fault_injector=FaultInjector(
            [FaultSpec(**d) for d in specs]))
    xs = np.arange(16.0, dtype=np.float32).reshape(8, 2)
    jf = jexe.submit_range((jnp.asarray(xs),), 0, 8)
    f = exe.submit_range((torch.from_numpy(xs),), 0, 8)
    jexe.flush()
    exe.flush()
    assert f.failed_indices() == jf.failed_indices() == [2, 5]
    assert str(f.error(2)) == str(jf.error(2))
    with pytest.raises(TaskFailedError):
        f.result()
    for i in (0, 1, 3, 4, 6, 7):
        np.testing.assert_array_equal(f.task_result(i).numpy(),
                                      np.asarray(jf.task_result(i)))
    (jreg,) = jexe.stats["regions"].values()
    (reg,) = exe.stats["regions"].values()
    assert reg["faults"] == jreg["faults"] == {"injected": 2, "trips": 1,
                                               "isolated": 2}
    assert exe.breaker_states() == jexe.breaker_states() == {"g": "closed"}


# ---------------------------------------------------------------------------
# the mesh: axes, the degenerate case, the reference's refusals
# ---------------------------------------------------------------------------

def test_subgrid_mesh_degenerate_and_axes():
    m = subgrid_mesh(1, devices=["cpu"])
    assert m.axis_names == ("pod", "data")
    assert m.shape == {"pod": 1, "data": 1}
    j = jsubgrid_mesh(1)
    assert m.axis_names == tuple(j.axis_names)
    assert m.shape == dict(j.shape)
    m4 = subgrid_mesh(0, pod=2, devices=["cpu"] * 4)
    assert m4.shape == {"pod": 2, "data": 2} and m4.size == 4
    assert m4.device_list == (CPU,) * 4
    assert subgrid_mesh(0, devices=["cpu"]).size == 1


@pytest.mark.parametrize("n, pod, devices", [
    (2, 1, None), (1, 3, None), (9, 1, 8), (6, 4, 8), (0, 3, 8)])
def test_subgrid_mesh_refusals_match_the_reference(n, pod, devices):
    """The same ``ValueError`` text as the reference's on its one CPU
    device (``devices=None``) or on a list of devices."""
    jdevs = None if devices is None else [jax.devices()[0]] * devices
    with pytest.raises(ValueError) as want:
        jsubgrid_mesh(n, pod=pod, devices=jdevs)
    tdevs = ["cpu"] * (devices or 1)
    with pytest.raises(ValueError) as got:
        subgrid_mesh(n, pod=pod, devices=tdevs)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# eight shards on one device: the reference's eight-device child
# ---------------------------------------------------------------------------

MESH8 = dict(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_mixed():
    """One JAX ``mixed`` step of the main path (the reference's test-1
    comparator, on its one device)."""
    jcfg = JHydroConfig(subgrid=8, ghost=3, levels=1)
    jst = jsedov_init(jcfg)
    jdt = jcourant_dt(jst.u, jcfg)
    out = JStrategyRunner(JUniformSedovScenario(jcfg), JAggregationConfig(
        strategy="mixed", launch_watermark=WM)).rk3_step(jst.u, jdt)
    return np.array(jst.u), float(jdt), np.asarray(out)


def test_eight_shards_uniform_step(jax_mixed):
    """Child check 1: the 8-shard step is bit-equal to the port's ``mixed``
    and within the kernel tolerance of the JAX ``mixed`` step."""
    u0, dt, want = jax_mixed
    u = torch.from_numpy(u0)
    r = StrategyRunner(UniformSedovScenario(CFG), _agg(shard_devices=8),
                       device="cpu", mesh=subgrid_mesh(8, **MESH8))
    out = r.rk3_step(u, dt)
    mixed = StrategyRunner(UniformSedovScenario(CFG), _agg(strategy="mixed"),
                           device="cpu").rk3_step(u, dt)
    assert torch.equal(out, mixed)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    stats = r.executor.stats
    assert stats["mesh"] == {"pod": 1, "data": 8}
    assert stats["n_shards"] == 8
    assert stats["shard_occupancy"] == [1] * 8
    assert stats["backend_key"] == ("cpu", "cpu", "d8")
    # 8 tasks: each shard one bucket of 1, per stage
    assert stats["aggregated_hist"] == {1: 24}
    assert stats["gather_copies"] == stats["scatter_copies"] == 0


def test_eight_shards_amr_equals_reference_step(amr):
    """Child check 2: AMR Sedov over 8 shards, bit-equal to the port's
    per-level reference step."""
    state, dt, _ = amr
    ref_c, ref_f = amr_reference_step(*state, dt, AMR_CONFIG)
    out_c, out_f = StrategyRunner(
        AMRSedovScenario(AMR_CONFIG), _agg(), device="cpu",
        mesh=subgrid_mesh(8, **MESH8)).rk3_step(state, dt)
    assert torch.equal(out_c, ref_c)
    assert torch.equal(out_f, ref_f)


def test_eight_shards_gather_is_zero_copy_and_halo_rolls():
    """Child checks 3 and 4: a whole range over 8 shards is one output,
    uncopied, and ``gather_futures`` concatenates two; ``halo_exchange``
    rolls shard blocks one step along ``data`` (``np.roll``), and along
    ``pod`` on a 2 x 4 mesh."""
    exe = ShardedAggregationExecutor(
        lambda x, out=None: torch.mul(x, 3.0, out=out), config=_agg(),
        name="zc", mesh=subgrid_mesh(8, **MESH8))
    xs = torch.arange(64.0).reshape(16, 4)
    f1 = exe.submit_range((xs,), 0, 16)
    f2 = exe.submit_range((xs,), 0, 16)
    exe.flush()
    batch = f1._parts[0][1]
    r1 = f1.result()
    assert r1 is batch
    assert exe.ghost_gather(r1) is r1
    both = gather_futures([f1, f2])
    assert torch.equal(both, torch.cat([xs * 3.0] * 2))
    assert exe.stats["shard_occupancy"] == [4] * 8
    h = torch.arange(32.0).reshape(8, 4)
    assert np.array_equal(exe.halo_exchange(h).numpy(),
                          np.roll(h.numpy(), 1, axis=0))
    h2 = torch.arange(48.0).reshape(16, 3)
    assert np.array_equal(exe.halo_exchange(h2).numpy(),
                          np.roll(h2.numpy(), 2, axis=0))
    exe24 = ShardedAggregationExecutor(
        lambda x, out=None: x, config=_agg(), name="h",
        mesh=subgrid_mesh(8, pod=2, **MESH8))
    grid = h.numpy().reshape(2, 4, 1, 4)
    assert np.array_equal(exe24.halo_exchange(h).numpy(),
                          np.roll(grid, 1, axis=1).reshape(8, 4))
    assert np.array_equal(exe24.halo_exchange(h, "pod").numpy(),
                          np.roll(grid, 1, axis=0).reshape(8, 4))
    with pytest.raises(KeyError, match="model"):
        exe24.halo_exchange(h, "model")
    with pytest.raises(ValueError, match="shard blocks"):
        exe24.halo_exchange(torch.zeros(6, 2))


def test_eight_shards_tenants_fill_every_shard(jax_mixed):
    """Child check 5: 4 tenants over 8 shards equal the port's solo step
    and fill every shard evenly, 4 x ``n_subgrids`` in all."""
    u0, dt, _ = jax_mixed
    u = torch.from_numpy(u0)
    solo = StrategyRunner(UniformSedovScenario(CFG), _agg(strategy="mixed"),
                          device="cpu").rk3_step(u, dt)
    exe = ShardedAggregationExecutor(config=_agg(), name="tenancy",
                                     mesh=subgrid_mesh(8, **MESH8))
    tb = TenantBatcher(exe)
    for tid in range(4):
        tb.add(tid, UniformSedovScenario(CFG), u, dt)
    merged = tb.rk3_step_all()
    for tid in range(4):
        assert torch.equal(merged[tid], solo)
    occ = exe.stats["shard_occupancy"]
    assert len(occ) == 8 and len(set(occ)) == 1 and occ[0] > 0, occ
    assert sum(occ) == 4 * CFG.n_subgrids
    assert tb.healthz()["shard_occupancy"] == occ


def test_remainder_drains_on_the_primary():
    """11 tasks over 4 shards: 2 each through the shard program, 3 through
    the remainder's on shard 0, every task equal to the body."""
    def body(x, out=None):
        return torch.add(x * 2.0, 1.0, out=out)

    exe = ShardedAggregationExecutor(body, config=_agg(max_aggregated=4),
                                     name="rem",
                                     mesh=subgrid_mesh(4, devices=["cpu"] * 4))
    xs = torch.randn(13, 3, generator=torch.Generator().manual_seed(0))
    fut = exe.submit_range((xs,), 1, 11)
    exe.flush()
    assert torch.equal(fut.result(), body(xs[1:12]))
    (region,) = exe.regions.values()
    reg = region.stats
    assert reg["sharded_launches"] == 1 and reg["remainder_launches"] == 1
    assert exe.stats["shard_occupancy"] == [5, 2, 2, 2]
    # the shards' buckets (2 each) and the remainder's (2 + 1)
    assert exe.stats["aggregated_hist"] == {2: 5, 1: 1}
    assert exe.pool.launches_by_family == {"rem": 6}
    assert {k[0] for k in region.compiled} == {"shard", "rem"}


def test_two_devices_scatter_and_gather_in_shard_order(jax_mixed):
    """A mesh over two devices (``cpu:0``, ``cpu:1``, interleaved): each
    device drains its shards through its own program, and the drain copies
    every shard back in shard order; the step equals ``mixed`` and the
    copies are counted."""
    u0, dt, _ = jax_mixed
    u = torch.from_numpy(u0)
    mesh = subgrid_mesh(4, devices=["cpu:0", "cpu:1", "cpu:0", "cpu:1"])
    r = StrategyRunner(UniformSedovScenario(CFG), _agg(), device="cpu",
                       mesh=mesh)
    out = r.rk3_step(u, dt)
    mixed = StrategyRunner(UniformSedovScenario(CFG), _agg(strategy="mixed"),
                           device="cpu").rk3_step(u, dt)
    assert torch.equal(out, mixed)
    stats = r.executor.stats
    # 3 stages x 4 shards, each one copy in and one copy out
    assert stats["scatter_copies"] == stats["gather_copies"] == 12
    assert stats["shard_occupancy"] == [2] * 4
    (region,) = r.executor.regions.values()
    (key,) = region.compiled
    assert key[:2] == ("shard", 2)
    drain = region.compiled[key]
    assert [(str(d), idx) for d, idx, _ in drain.parts] == [
        ("cpu:0", [0, 2]), ("cpu:1", [1, 3])]
    exe = ShardedAggregationExecutor(
        lambda x, out=None: torch.mul(x, -1.0, out=out), config=_agg(),
        name="t", mesh=mesh)
    xs = torch.arange(24.0).reshape(8, 3)
    f = exe.submit_range((xs,), 0, 8)
    exe.flush()
    assert torch.equal(f.result(), -xs)
