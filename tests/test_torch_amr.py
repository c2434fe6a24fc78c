"""The port's two-level AMR Sedov scenario against the JAX reference.

The same inputs, made with numpy from a seed (or the reference's own AMR
initial condition carried across per level with ``state_from_numpy``), go
through ``repro`` (on the CPU) and ``repro_torch``.  Within the port every
strategy equals the per-level fused reference bit for bit, on both levels
and both layouts; across the two frameworks the levels agree allclose, with
each tolerance stated where it is used.  The CUDA kernels themselves are
tested on the card by tests/test_torch_cuda.py.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import amr_sedov as jamr_configs  # noqa: E402
from repro.configs.base import AMRHydroConfig as JAMRHydroConfig  # noqa: E402
from repro.hydro import state as jstate  # noqa: E402
from repro.hydro import stepper as jstepper  # noqa: E402

from repro_torch import amr_sedov  # noqa: E402
from repro_torch.configs.amr_sedov import CONFIG, CONFIG_MIXED  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    AggregationConfig, AMRHydroConfig,
)
from repro_torch.core import AMRSedovScenario, StrategyRunner  # noqa: E402
from repro_torch.hydro.state import (  # noqa: E402
    amr_sedov_init, extract_subgrids_multilevel, prolong_coarse,
    restrict_fine, state_from_numpy, state_to_numpy, sync_coarse,
)
from repro_torch.hydro.stepper import (  # noqa: E402
    amr_courant_dt, amr_reference_rhs, amr_reference_step, amr_run,
)
from repro_torch.kernels.ops import level_batched_body  # noqa: E402

BIG = dict(name="amr_sedov_1024", coarse_grids_per_edge=8, cover=32)
CONFIGS = {"CONFIG": (CONFIG, jamr_configs.CONFIG),
           "CONFIG_MIXED": (CONFIG_MIXED, jamr_configs.CONFIG_MIXED),
           "amr_sedov_1024": (AMRHydroConfig(**BIG), JAMRHydroConfig(**BIG))}
PROPERTIES = ("n_coarse", "n_fine", "fine_grids_per_edge", "offset",
              "h_coarse", "h_fine", "coarse_ghost_pad", "n_subgrids_coarse",
              "n_subgrids_fine")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def lane_body(cfg):
    return functools.partial(level_batched_body, cfg.gamma, cfg.ghost,
                             layout="slot_lane")


def random_levels(cfg, seed):
    """A positive random two-level state (uc, uf), float32 numpy."""
    rng = np.random.default_rng(seed)
    return tuple((1.0 + rng.random((5, n, n, n))).astype(np.float32)
                 for n in (cfg.n_coarse, cfg.n_fine))


def assert_close(got, want, rel=1e-6):
    """rtol ``rel``, atol ``rel`` x max|want|: restriction averages in
    another summation order than XLA's, a few ulps at most."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_amr_config_matches_reference(name):
    mine, theirs = CONFIGS[name]
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for prop in PROPERTIES:
        assert getattr(mine, prop) == getattr(theirs, prop), prop


@pytest.mark.parametrize("kw", [
    dict(cover=7),                                       # cannot centre
    dict(coarse_grids_per_edge=1, coarse_subgrid=8, cover=8),  # at the edge
    dict(fine_subgrid=7),                                # does not divide
])
def test_amr_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as theirs:
        JAMRHydroConfig(**kw)
    with pytest.raises(ValueError) as mine:
        AMRHydroConfig(**kw)
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# the coarse-fine exchange
# ---------------------------------------------------------------------------

def test_restrict_and_prolong_match_reference():
    rng = np.random.default_rng(100)
    x = rng.standard_normal((5, 4, 4, 4)).astype(np.float32)
    fine = rng.standard_normal((5, 8, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(prolong_coarse(T(x), 2).numpy(),
                                  np.asarray(jstate.prolong_coarse(x, 2)))
    assert torch.equal(restrict_fine(prolong_coarse(T(x), 2), 2), T(x))
    assert_close(restrict_fine(T(fine), 2),
                 jstate.restrict_fine(jnp.asarray(fine), 2))


@pytest.mark.parametrize("name", ["CONFIG", "CONFIG_MIXED"])
def test_sync_and_multilevel_extract_match_reference(name):
    mine, theirs = CONFIGS[name]
    uc, uf = random_levels(mine, 101)
    tc, tf = T(uc), T(uf)
    synced = sync_coarse(tc, tf, mine)
    assert_close(synced, jstate.sync_coarse(uc, uf, theirs))
    assert torch.equal(tc, T(uc)) and synced.data_ptr() != tc.data_ptr()
    want_c, want_f = jstate.extract_subgrids_multilevel(uc, uf, theirs)
    subs_c, subs_f = extract_subgrids_multilevel(tc, tf, mine)
    pc, pf = mine.coarse_subgrid + 6, mine.fine_subgrid + 6
    assert subs_c.shape == (mine.n_subgrids_coarse, 5, pc, pc, pc)
    assert subs_f.shape == (mine.n_subgrids_fine, 5, pf, pf, pf)
    assert subs_c.is_contiguous() and subs_f.is_contiguous()
    assert_close(subs_c, want_c)
    assert_close(subs_f, want_f)
    assert torch.equal(tc, T(uc)) and torch.equal(tf, T(uf))


@pytest.mark.parametrize("name", ["CONFIG", "CONFIG_MIXED"])
def test_amr_sedov_init_and_courant_dt_match_reference(name):
    mine, theirs = CONFIGS[name]
    want = jstate.amr_sedov_init(theirs)
    got = amr_sedov_init(mine, device="cpu")
    for a, b in ((got.uc, want.uc), (got.uf, want.uf)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert_close(a, b)
    assert (got.t, got.step) == (0.0, 0)
    uc, uf = (state_from_numpy(np.asarray(x), "cpu")
              for x in (want.uc, want.uf))
    dt = amr_courant_dt(uc, uf, mine)
    assert dt.dim() == 0 and dt.device == uc.device
    np.testing.assert_allclose(
        float(dt), float(jstepper.amr_courant_dt(want.uc, want.uf, theirs)),
        rtol=1e-6)


def test_constant_state_has_zero_rhs_on_both_levels():
    """A spatially constant state is an exact fixed point: the prolongated
    fine ghost band and the restricted coarse overlap both reproduce the
    constant, so every flux difference is 0.0."""
    const = torch.tensor([1.0, 0.0, 0.0, 0.0, 2.5])[:, None, None, None]
    uc = const.expand(5, *(CONFIG.n_coarse,) * 3).contiguous()
    uf = const.expand(5, *(CONFIG.n_fine,) * 3).contiguous()
    duc, duf = amr_reference_rhs(uc, uf, CONFIG)
    assert not bool(duc.any()) and not bool(duf.any())


# ---------------------------------------------------------------------------
# the acceptance invariant: every strategy == the per-level fused reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def amr_reference():
    st = amr_sedov_init(CONFIG, device="cpu")
    dt = amr_courant_dt(st.uc, st.uf, CONFIG)
    return st, dt, amr_reference_step(st.uc, st.uf, dt, CONFIG)


@pytest.mark.parametrize("strategy,cap,n_exec", [
    ("fused", 32, 1), ("s3", 16, 1), ("s3", 2, 1), ("s2+s3", 4, 4)])
def test_amr_strategy_bit_identical_to_reference(amr_reference, strategy,
                                                 cap, n_exec):
    st, dt, (ref_c, ref_f) = amr_reference
    agg = AggregationConfig(strategy=strategy, max_aggregated=cap,
                            n_executors=n_exec)
    runner = StrategyRunner(AMRSedovScenario(CONFIG), agg, device="cpu")
    runner.warmup()
    out_c, out_f = runner.rk3_step((st.uc, st.uf), dt)
    assert torch.equal(out_c, ref_c) and torch.equal(out_f, ref_f)
    per_level = 1 if strategy == "fused" else 8 // min(cap, 8)
    assert runner.stats["kernel_launches"] == 3 * 2 * per_level


def test_amr_shared_shape_levels_share_one_family(amr_reference):
    """CONFIG: both levels use 8^3 sub-grids, so ONE region serves coarse
    and fine tasks: 3 iterations x (1 coarse + 1 fine) bucket-8 launches,
    as the reference's tests/test_amr.py pins."""
    st, dt, _ = amr_reference
    runner = StrategyRunner(AMRSedovScenario(CONFIG), AggregationConfig(
        strategy="s3", max_aggregated=16), device="cpu")
    runner.rk3_step((st.uc, st.uf), dt)
    assert {k: v["aggregated_hist"]
            for k, v in runner.stats["regions"].items()} == {
        "hydro_rhs_s8[5x14x14x14,scalar]": {8: 6}}
    assert runner.launches_by_family == {"hydro_rhs_s8": 6}
    assert [f.kernel for f in runner.scenario.families()] == ["hydro_rhs_s8"]


def test_amr_mixed_two_families_on_the_lane_layout():
    """CONFIG_MIXED on the lane layout: a 16^3 coarse family and an 8^3
    fine family through one executor, bit-identical to the reference on
    the same bodies, and within the kernel tolerance of the slot_grid
    layout."""
    cfg = CONFIG_MIXED
    st = amr_sedov_init(cfg, device="cpu")
    dt = amr_courant_dt(st.uc, st.uf, cfg)
    ref = amr_reference_step(st.uc, st.uf, dt, cfg, level_body=lane_body(cfg))
    runner = StrategyRunner(AMRSedovScenario(cfg, hydro_body=lane_body(cfg)),
                            AggregationConfig(strategy="s3",
                                              max_aggregated=16),
                            device="cpu")
    out = runner.rk3_step((st.uc, st.uf), dt)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert {k: v["aggregated_hist"]
            for k, v in runner.stats["regions"].items()} == {
        "hydro_rhs_s16[5x22x22x22,scalar]": {1: 3},
        "hydro_rhs_s8[5x14x14x14,scalar]": {8: 3}}
    assert runner.launches_by_family == {"hydro_rhs_s16": 3,
                                         "hydro_rhs_s8": 3}
    grid = amr_reference_step(st.uc, st.uf, dt, cfg)
    for a, b in zip(out, grid):
        assert_close(a, b, rel=2e-5)


def test_amr_matches_reference_after_two_steps():
    """The reference's AMR IC, carried across level by level and stepped 2
    RK3 steps by the port's s3 runner over the reference's dts.

    Tolerance: each stage's RHS agrees to the kernel tolerance (2e-6 of
    scale); over 6 stages, and the restriction's summation order at every
    sync, float32 rounding of two frameworks compounds, so each level is
    held at rtol=1e-5 with atol=1e-6 of its largest value, as the uniform
    path is (tests/test_torch_runtime.py).
    """
    st = jstate.amr_sedov_init(jamr_configs.CONFIG)
    uc, uf, dts = st.uc, st.uf, []
    for _ in range(2):
        dts.append(jstepper.amr_courant_dt(uc, uf, jamr_configs.CONFIG))
        uc, uf = jstepper.amr_reference_step(uc, uf, dts[-1],
                                             jamr_configs.CONFIG)
    state = tuple(state_from_numpy(np.asarray(x), "cpu")
                  for x in (st.uc, st.uf))
    runner = StrategyRunner(AMRSedovScenario(CONFIG), AggregationConfig(
        strategy="s3", max_aggregated=4), device="cpu")
    for dt in dts:
        state = runner.rk3_step(state, torch.tensor(np.float32(dt)))
    for got, want in zip(state, (uc, uf)):
        got, want = state_to_numpy(got), np.asarray(want)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()))


def test_amr_run_stays_physical():
    """Two Courant steps of the blast stay finite with positive density and
    a bounded internal-energy undershoot (E - KE) on both levels, the
    reference's tests/test_amr.py bound."""
    st = amr_run(amr_sedov_init(CONFIG, device="cpu"), CONFIG, n_steps=2)
    for u in (st.uc, st.uf):
        assert bool(torch.isfinite(u).all())
        assert bool((u[0] > 0).all())
        ke = 0.5 * (u[1] ** 2 + u[2] ** 2 + u[3] ** 2) / u[0]
        assert bool((u[4] - ke > -1e-2 * u[4].max()).all())
    assert st.t > 0.0 and st.step == 2


def test_runner_checks_every_level_and_the_example_runs(capsys):
    runner = StrategyRunner(AMRSedovScenario(CONFIG), AggregationConfig(),
                            device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        runner.rhs((torch.zeros(5, 16, 16, 16),
                    torch.zeros(5, 16, 16, 16, device="meta")))
    amr_sedov.main(["--device", "cpu", "--mixed", "--layout", "slot_lane"])
    out = capsys.readouterr().out
    assert "all strategies bit-identical" in out and "on cpu" in out
