"""The port's checkpoints (``repro_torch.checkpoint``) and the runner's
crash-consistent ``run`` / ``resume``, against the JAX reference.

Files move between the packages in both directions bit for bit: the
same keys (``params//<path>``, ``#i`` per tuple index), the same sidecar,
the same publish order.  Within the port a resumed trajectory equals an
uninterrupted one bit for bit, also after the process was killed by
SIGKILL; a JAX run resumed by the port agrees with JAX's own run within
the kernel tolerance between the frameworks (rtol 1e-5, atol 1e-5 x
max|u|, as ``tests/test_slot_ring.py``).
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.configs.base import HydroConfig as JHydroConfig  # noqa: E402
from repro.core import StrategyRunner as JStrategyRunner  # noqa: E402
from repro.core import UniformSedovScenario as JUniformSedovScenario  # noqa: E402
from repro.hydro import state as jstate  # noqa: E402
from repro.hydro import stepper as jstepper  # noqa: E402

from repro_torch.checkpoint import (  # noqa: E402
    latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.configs.amr_sedov import CONFIG as ACFG  # noqa: E402
from repro_torch.configs.base import AggregationConfig, HydroConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AMRSedovScenario, StrategyRunner, UniformSedovScenario,
)
from repro_torch.hydro.state import (  # noqa: E402
    amr_sedov_init, sedov_init, state_from_numpy,
)
from repro_torch.hydro.stepper import amr_courant_dt, courant_dt  # noqa: E402

CFG = HydroConfig(subgrid=8, ghost=3, levels=1)
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    u0 = sedov_init(CFG, device="cpu").u
    return u0, courant_dt(u0, CFG)


def _agg(**kw):
    """``s3`` on one executor draining each wave as one bucket: no knob
    that depends on timing."""
    return AggregationConfig(**{**dict(
        strategy="s3", n_executors=1, max_aggregated=CFG.n_subgrids,
        launch_watermark=10 ** 9), **kw})


def _random(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


ROUND_TRIPS = {
    "tensor": lambda: _random(0, 5, 4, 4, 4),
    "tuple": lambda: (_random(1, 5, 4, 4, 4), _random(2, 5, 8, 8, 8)),
    "dict": lambda: {"w": _random(3, 3, 2), "b": {"x": _random(4, 2),
                                                  "y": (_random(5, 1),)}},
    "bf16": lambda: _random(6, 4, 3).to(torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_round_trip(tmp_path, case):
    tree = ROUND_TRIPS[case]()
    save_checkpoint(str(tmp_path), 3, tree, {}, meta={"dt": 0.25})
    got, opt, meta = restore_checkpoint(str(tmp_path), 3, tree, {})
    assert _equal(got, tree) and opt == {}
    assert meta == {"step": 3, "dt": 0.25}
    with np.load(tmp_path / "step_00000003.npz") as data:
        # npz has no bf16: stored as fp32, cast back on restore
        assert all(data[k].dtype == np.float32 for k in data.files)


def test_keys_are_the_reference_path_strings(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": (_random(0, 2), _random(1, 2))},
                    {"m": _random(2, 2)})
    save_checkpoint(str(tmp_path), 2, _random(3, 2), {})
    with np.load(tmp_path / "step_00000001.npz") as data:
        assert sorted(data.files) == ["opt//m", "params//a//#0",
                                      "params//a//#1"]
    with np.load(tmp_path / "step_00000002.npz") as data:
        assert data.files == ["params//"]


def test_restore_lands_on_the_template_device_and_dtype(tmp_path):
    save_checkpoint(str(tmp_path), 1, _random(0, 3), {})
    got, _, _ = restore_checkpoint(str(tmp_path), 1,
                                   torch.zeros(3, dtype=torch.float64), {})
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert torch.equal(got, _random(0, 3).double())


def test_crash_artifacts_never_move_latest(tmp_path):
    """A crash before the sidecar's rename leaves a stray ``.tmp``; one
    between the renames a sidecar without its npz.  Neither shadows the
    last whole checkpoint, which restores."""
    u0, _ = _setup()
    ckpt = str(tmp_path)
    save_checkpoint(ckpt, 1, u0, {}, meta={"dt": 0.1})
    open(os.path.join(ckpt, "garbage.tmp"), "w").close()
    with open(os.path.join(ckpt, "step_00000007.npz.json"), "w") as f:
        f.write('{"step": 7}')
    assert latest_step(ckpt) == 1
    state, _, meta = restore_checkpoint(ckpt, 1, u0, {})
    assert torch.equal(state, u0) and meta["step"] == 1
    assert latest_step(str(tmp_path / "missing")) is None


def _jax_tree(case):
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((5, 4, 4, 4), (5, 8, 8, 8))]
    return arrays[0] if case == "bare" else tuple(arrays)


def _to_torch(tree):
    if isinstance(tree, tuple):
        return tuple(_to_torch(x) for x in tree)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("case", ["bare", "tuple"])
def test_jax_file_restores_in_port(tmp_path, case):
    tree = _jax_tree(case)
    jtree = (jnp.asarray(tree) if case == "bare"
             else tuple(jnp.asarray(x) for x in tree))
    meta = {"dt": 0.0123, "n_steps": 4, "scenario": "sedov"}
    jckpt.save_checkpoint(str(tmp_path), 2, jtree, {}, meta=meta)
    got, _, got_meta = restore_checkpoint(str(tmp_path), 2,
                                          _to_torch(tree), {})
    assert _equal(got, _to_torch(tree))
    assert got_meta == {"step": 2, **meta}


@pytest.mark.parametrize("case", ["bare", "tuple"])
def test_port_file_restores_in_jax(tmp_path, case):
    tree = _to_torch(_jax_tree(case))
    meta = {"dt": 0.0123, "n_steps": 4, "strategy": "s3"}
    save_checkpoint(str(tmp_path), 5, tree, {}, meta=meta)
    template = _jax_tree(case)
    assert jckpt.latest_step(str(tmp_path)) == 5
    got, _, got_meta = jckpt.restore_checkpoint(str(tmp_path), 5, template,
                                                {})
    for g, want in zip(got if case == "tuple" else (got,),
                       tree if case == "tuple" else (tree,)):
        np.testing.assert_array_equal(np.asarray(g), want.numpy())
    assert got_meta == {"step": 5, **meta}


def test_run_with_checkpoints_matches_plain_run(tmp_path):
    u0, dt = _setup()
    ckpt = str(tmp_path / "ckpt")
    out = StrategyRunner(UniformSedovScenario(CFG), _agg(),
                         device="cpu").run(u0, dt, 3, checkpoint_every=2,
                                           ckpt_dir=ckpt)
    plain = StrategyRunner(UniformSedovScenario(CFG), _agg(),
                           device="cpu").run(u0, dt, 3)
    assert torch.equal(out, plain)
    # cadence 2 over 3 steps: step 2 (the cadence) and step 3 (the last)
    assert latest_step(ckpt) == 3
    assert sorted(os.listdir(ckpt)) == [
        "step_00000002.npz", "step_00000002.npz.json", "step_00000003.npz",
        "step_00000003.npz.json"]
    state, _, meta = restore_checkpoint(ckpt, 2, u0, {})
    assert meta["n_steps"] == 3 and meta["dt"] == float(dt)
    assert meta["checkpoint_every"] == 2
    assert meta["scenario"] == CFG.name and meta["strategy"] == "s3"
    two = StrategyRunner(UniformSedovScenario(CFG), _agg(),
                         device="cpu").run(u0, dt, 2)
    assert torch.equal(state, two)


def test_resume_without_checkpoint_raises(tmp_path):
    u0, _ = _setup()
    runner = StrategyRunner(UniformSedovScenario(CFG), _agg(), device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        runner.resume(str(tmp_path / "nothing"), u0)


def test_restored_float_dt_gives_the_tensor_bits():
    """``resume`` hands the saved dt back as a Python float: in ``u + dt *
    l`` and the stage combines it gives the 0-dim fp32 tensor's bits."""
    u, l = _random(10, 5, 16, 16, 16), _random(11, 5, 16, 16, 16)
    dt = torch.tensor(3.0e-3) * torch.tensor(1.7)       # not a round float
    back = json.loads(json.dumps(float(dt)))
    for a, b in ((u + dt * l, u + back * l),
                 (0.75 * u + 0.25 * (u + dt * l),
                  0.75 * u + 0.25 * (u + back * l)),
                 ((1.0 / 3.0) * u + (2.0 / 3.0) * (u + dt * l),
                  (1.0 / 3.0) * u + (2.0 / 3.0) * (u + back * l))):
        assert torch.equal(a, b)


_CHILD = """
import os, signal, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs.base import AggregationConfig, HydroConfig
from repro_torch.core import StrategyRunner, UniformSedovScenario
from repro_torch.hydro.state import sedov_init
from repro_torch.hydro.stepper import courant_dt

cfg = HydroConfig(subgrid=8, ghost=3, levels=1)
u0 = sedov_init(cfg, device="cpu").u
runner = StrategyRunner(UniformSedovScenario(cfg), AggregationConfig(
    strategy="s3", n_executors=1, max_aggregated=cfg.n_subgrids,
    launch_watermark=10 ** 9), device="cpu")
save = runner._checkpoint


def save_then_die(ckpt_dir, step, *args):
    save(ckpt_dir, step, *args)
    if step == 2:
        os.kill(os.getpid(), signal.SIGKILL)      # no clean-up at all


runner._checkpoint = save_then_die
runner.run(u0, courant_dt(u0, cfg), 4, checkpoint_every=1,
           ckpt_dir=sys.argv[1])
"""


def test_killed_run_resumes_bit_identical(tmp_path):
    """A child killed by SIGKILL right after checkpoint 2 of 4 (no timing
    involved: it kills itself there) resumes bit-identical to an
    uninterrupted run, from step 2 with 2 steps to recover."""
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    child = subprocess.run([sys.executable, "-c", _CHILD, ckpt], env=env,
                           capture_output=True, text=True, timeout=300)
    assert child.returncode == -signal.SIGKILL, child.stderr[-2000:]
    assert latest_step(ckpt) == 2
    u0, dt = _setup()
    want = StrategyRunner(UniformSedovScenario(CFG), _agg(),
                          device="cpu").run(u0, dt, 4)
    runner = StrategyRunner(UniformSedovScenario(CFG), _agg(), device="cpu")
    got = runner.resume(ckpt, u0)
    assert torch.equal(got, want)
    assert runner.stats["resumed_from_step"] == 2
    assert runner.stats["recovery_steps"] == 2
    assert latest_step(ckpt) == 4


class _Crash(Exception):
    pass


@pytest.mark.parametrize("strategy", ["fused", "s2+s3"])
def test_amr_resume_bit_identical(tmp_path, strategy):
    """The ``(uc, uf)`` state, stopped after checkpoint 2 of 3 (an
    exception in place of a kill), resumes bit-identical."""
    st = amr_sedov_init(ACFG, device="cpu")
    state, dt = (st.uc, st.uf), amr_courant_dt(st.uc, st.uf, ACFG)
    agg = AggregationConfig(strategy=strategy, max_aggregated=4)
    want = StrategyRunner(AMRSedovScenario(ACFG), agg,
                          device="cpu").run(state, dt, 3)
    ckpt = str(tmp_path / "ckpt")
    crashing = StrategyRunner(AMRSedovScenario(ACFG), agg, device="cpu")
    save = crashing._checkpoint

    def save_then_crash(ckpt_dir, step, *args):
        save(ckpt_dir, step, *args)
        if step == 2:
            raise _Crash
    crashing._checkpoint = save_then_crash
    with pytest.raises(_Crash):
        crashing.run(state, dt, 3, checkpoint_every=1, ckpt_dir=ckpt)
    runner = StrategyRunner(AMRSedovScenario(ACFG), agg, device="cpu")
    got = runner.resume(ckpt, state)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert runner.stats["recovery_steps"] == 1


def test_jax_run_resumed_by_port(tmp_path):
    """JAX runs 2 steps with a checkpoint after each; the port resumes the
    JAX file to 4 steps, within the kernel tolerance of JAX's own 4-step
    run."""
    jcfg = JHydroConfig(subgrid=8, ghost=3, levels=1)
    ju = jstate.sedov_init(jcfg).u
    jdt = jstepper.courant_dt(ju, jcfg)
    ckpt = str(tmp_path / "ckpt")
    jagg = JAggregationConfig(strategy="fused")
    JStrategyRunner(JUniformSedovScenario(jcfg), jagg).run(
        ju, jdt, 2, checkpoint_every=1, ckpt_dir=ckpt)
    want = np.asarray(JStrategyRunner(JUniformSedovScenario(jcfg),
                                      jagg).run(ju, jdt, 4))
    u0 = state_from_numpy(np.asarray(ju), "cpu")
    runner = StrategyRunner(UniformSedovScenario(CFG), _agg(), device="cpu")
    got = runner.resume(ckpt, u0, n_steps=4).numpy()
    assert runner.stats["resumed_from_step"] == 2
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
