"""The port's ``distributed/`` and the int8 all-reduce against the JAX
reference, on the CPU.

* The sharding rules: ``spec_for`` on the fake meshes of
  ``tests/test_substrate.py`` and on 400 seeded (shape, names, overrides)
  draws over three meshes, equal to the reference's (``tuple(jax_spec) ==
  port_spec``); ``ShardingRules.axis_size``; ``constrain`` returning its
  input (without rules, without a mesh, and with both).
* ``resilient_loop``: the same state and stats as the reference's under
  six failure schedules, and the same "unrecoverable" refusal.
* ``compressed_allreduce`` on a gloo group of 1 against the reference's
  on a one-device ``shard_map``, 20 error-feedback steps (mean and
  residual within 4 ulps of max|g|), and on a spawned gloo group of 2
  ranks against a numpy evaluation of the same formula in fp32, bit for
  bit, over 3 steps.
* ``make_dp_train_step`` on reduced granite-8b (a stream batch, which
  holds no padding label, so two halves hold equal token counts): 2
  spawned gloo ranks with half the batch each, ``compress=False``, bit-
  equal to the port's ``make_train_step`` at microbatch 2 on the whole
  batch and held to the reference's ``make_dp_train_step`` on a one-device
  mesh with the whole batch (the loss within rtol 1e-5, every weight's
  update as ``test_torch_train_step.py`` holds it); at world size 1,
  ``compress=True`` against the reference's and ``compress=False`` bit-
  equal to ``make_train_step``.
* ``restore_resharded`` of a JAX-saved checkpoint (bf16 and fp32 leaves,
  tensor and numpy templates) bit for bit, and ``rescale_state``.
* ``ExecutorPool(scheduling="load")``: the reference's pick sequence with
  ``busy`` faked.

Spawned ranks are subprocesses that meet in a ``FileStore`` under the
test's ``tmp_path`` and are killed at a timeout of their own.
"""
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.executor import ExecutorPool as JExecutorPool  # noqa: E402
from repro.distributed import api as japi  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.compression import compressed_allreduce as jallreduce  # noqa: E402,E501

from repro_torch.checkpoint import (  # noqa: E402
    restore_resharded, save_checkpoint,
)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.executor import ExecutorPool  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream  # noqa: E402,E501
from repro_torch.distributed import (  # noqa: E402
    NamedSharding, PartitionSpec, ShardingRules, SimulatedFailure,
    constrain, current_rules, logical_rules, make_dp_train_step,
    process_group, rescale_state, residual_init, resilient_loop, spec_for,
    subgrid_mesh,
)
from repro_torch.distributed.api import DEFAULT_RULES, tree_map  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import convert, model  # noqa: E402
from repro_torch.optim import OptConfig, compressed_allreduce, opt_init  # noqa: E402,E501

from test_torch_families import perturb  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCH = "granite-8b"
B, S = 4, 16
OPT = OptConfig(lr=3e-4, warmup_steps=2, total_steps=10)
RANK_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------

def _fake_mesh(**axes):
    return SimpleNamespace(shape=dict(axes))


def _both(shape, names, mesh, overrides=None):
    with japi.logical_rules(mesh, overrides):
        want = japi.spec_for(shape, names)
    with logical_rules(mesh, overrides):
        got = spec_for(shape, names)
    assert isinstance(got, PartitionSpec)
    return got, want


def test_spec_divisibility_and_used_axes_match_the_reference():
    """The cases of ``tests/test_substrate.py:197``–``:222``."""
    mesh = _fake_mesh(pod=2, data=16, model=16)
    cases = [((256, 128), ["batch", None], None),
             ((1, 128), ["batch", None], None),
             ((4096, 8), [None, "kv_heads"], None),
             ((4096, 32), [None, "heads"], None),
             ((128, 32768, 8, 128), ["batch", "kv_seq", "kv_heads", None],
              {"kv_seq": ("pod", "data", "model")}),
             ((1, 524288, 8, 128), ["batch", "kv_seq", "kv_heads", None],
              {"kv_seq": ("pod", "data", "model")})]
    for shape, names, ov in cases:
        got, want = _both(shape, names, mesh, ov)
        assert tuple(want) == got
    got, _ = _both((256, 128), ["batch", None], mesh)
    assert got == PartitionSpec(("pod", "data"), None)
    got, _ = _both((1, 524288, 8, 128), ["batch", "kv_seq", "kv_heads",
                                         None], mesh,
                   {"kv_seq": ("pod", "data", "model")})
    assert got == PartitionSpec(None, ("pod", "data", "model"), None, None)


@pytest.mark.parametrize("mesh_axes", [
    dict(pod=2, data=16, model=16), dict(data=16, model=16),
    dict(pod=1, data=8, model=4)])
def test_spec_for_matches_the_reference_on_seeded_draws(mesh_axes):
    rng = np.random.default_rng(sum(mesh_axes.values()))
    mesh = _fake_mesh(**mesh_axes)
    logical = list(DEFAULT_RULES) + [None, "unknown"]
    sizes = [1, 2, 3, 4, 8, 12, 16, 24, 32, 48, 64, 128, 256, 4096, 32768,
             256206]
    axes = ("pod", "data", "model")
    for _ in range(400):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(sizes)) for _ in range(nd))
        names = [logical[int(i)] for i in rng.integers(0, len(logical), nd)]
        ov = None
        if rng.random() < 0.5:
            key = logical[int(rng.integers(0, len(DEFAULT_RULES)))]
            pick = tuple(a for a in axes if rng.random() < 0.6)
            ov = {key: pick or None}
        got, want = _both(shape, names, mesh, ov)
        assert tuple(want) == got, (shape, names, ov)


def test_rules_context_and_constrain_match_the_reference():
    assert current_rules() is None and japi.current_rules() is None
    x = torch.ones(4, 4)
    assert constrain(x, "batch", "embed") is x
    mesh = _fake_mesh(pod=2, data=4, model=2)
    with logical_rules(mesh, {"embed": ("model",)}) as r, \
            japi.logical_rules(mesh, {"embed": ("model",)}) as jr:
        assert current_rules() is r
        assert r.rules == jr.rules
        for spec in (None, "model", ("pod", "data"), ("pod", "x")):
            assert r.axis_size(spec) == jr.axis_size(spec)
        assert constrain(x, "batch", "embed") is x
        with pytest.raises(AssertionError):
            constrain(x, "batch")
        with logical_rules(None):
            assert constrain(x, "batch") is x      # no mesh: a no-op
        assert current_rules() is r
    assert current_rules() is None
    assert ShardingRules().rules == japi.ShardingRules().rules


def test_mesh_and_named_placement():
    m = subgrid_mesh(4, pod=2, devices=["cpu"] * 4)
    assert m.devices.shape == (2, 2) and m.local_device == torch.device("cpu")
    sh = NamedSharding(m, PartitionSpec())
    assert sh.spec == () and sh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="2-d devices"):
        type(m)(m.devices, ("data",))


# ---------------------------------------------------------------------------
# resilient_loop
# ---------------------------------------------------------------------------

def _run_loop(loop, failure, fail_at, n_steps=20, save_every=5,
              restore=True, max_retries=3):
    saves = {}
    fail_at = list(fail_at)

    def hook(step):
        if step in fail_at:
            fail_at.remove(step)
            raise failure(f"node lost at step {step}")

    def step_fn(state, step):
        return state * 3 + step + 1

    return loop(step_fn, 0, n_steps, save_every=save_every,
                save_fn=lambda st, step: saves.__setitem__(step, st),
                restore_fn=saves.__getitem__ if restore else None,
                failure_hook=hook, max_retries=max_retries)


@pytest.mark.parametrize("fail_at, save_every, restore", [
    ((7, 13), 5, True), ((), 5, True), ((0, 0, 1), 5, True),
    ((3, 12, 12, 19), 4, True), ((6, 9), 5, False), ((4,), 1, True)])
def test_resilient_loop_matches_the_reference(fail_at, save_every, restore):
    got = _run_loop(resilient_loop, SimulatedFailure, fail_at,
                    save_every=save_every, restore=restore)
    want = _run_loop(jft.resilient_loop, jft.SimulatedFailure, fail_at,
                     save_every=save_every, restore=restore)
    assert got == want
    assert got[1]["failures"] == len(fail_at)


def test_resilient_loop_gives_up_after_retries():
    for loop, failure in ((resilient_loop, SimulatedFailure),
                          (jft.resilient_loop, jft.SimulatedFailure)):
        with pytest.raises(RuntimeError, match="unrecoverable: 3 "):
            _run_loop(loop, failure, (2, 2, 2, 2), max_retries=2)
    # an error that is no lost step is not retried
    with pytest.raises(KeyError):
        resilient_loop(lambda s, i: {}[i], 0, 3)


# ---------------------------------------------------------------------------
# compressed_allreduce
# ---------------------------------------------------------------------------

@pytest.fixture
def group_of_one(tmp_path):
    with process_group(0, 1, device="cpu",
                       store_path=str(tmp_path / "store")) as dev:
        yield dev


def test_compressed_allreduce_group_of_one_matches_the_reference(
        group_of_one):
    """20 error-feedback steps of the same gradient, as the reference's
    ``test_compressed_allreduce_error_feedback``: every step's mean and
    residual within 4 fp32 ulps of max|g| of the reference's (XLA
    contracts the residual's ``g - q * scale`` into one fma), and the
    accumulated error within its bar."""
    from jax.experimental.shard_map import shard_map
    mesh = jax.make_mesh((1,), ("data",))
    jstep = jax.jit(shard_map(lambda g, r: jallreduce(g, "data", r),
                              mesh=mesh, in_specs=(JP(), JP()),
                              out_specs=(JP(), JP()), check_rep=False))
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64,)))
    jres = jnp.zeros_like(g)
    res = torch.zeros(64)
    tg = torch.from_numpy(g.copy())
    total_true, total_sent = np.zeros(64), np.zeros(64)
    ulp = float(np.abs(g).max()) * 2.0 ** -23
    for _ in range(20):
        jmean, jres = jstep(jnp.asarray(g), jres)
        mean, res = compressed_allreduce(tg, None, res)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0,
                                   atol=4 * ulp)
        np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=0,
                                   atol=4 * ulp)
        total_true += g
        total_sent += mean.numpy()
    assert np.abs(total_sent - total_true).max() < np.abs(g).max() * 0.02


def _np_allreduce(gs, rs):
    """The reference's formula in numpy fp32 over the ranks' gradients."""
    gs = [g + r for g, r in zip(gs, rs)]
    scale = max(np.float32(max(np.abs(g).max(), np.float32(1e-12)))
                / np.float32(127.0) for g in gs)
    qs = [np.clip(np.rint(g / scale), -127, 127).astype(np.int8) for g in gs]
    total = sum(q.astype(np.int32) for q in qs)
    mean = total.astype(np.float32) * scale / np.float32(len(gs))
    return mean, [g - q.astype(np.float32) * scale for g, q in zip(gs, qs)]


# ---------------------------------------------------------------------------
# two spawned gloo ranks: the all-reduce and the data-parallel step
# ---------------------------------------------------------------------------

RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import (make_dp_train_step, process_group,
                                         residual_init)
    from repro_torch.models import convert, model
    from repro_torch.optim import OptConfig, compressed_allreduce, opt_init

    rank, world, store, work = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    with process_group(rank, world, device="cpu", store_path=store,
                       timeout_s=120):
        data = np.load(f"{work}/inputs.npz")
        # the all-reduce: 3 error-feedback steps of this rank's gradient
        g = torch.from_numpy(data[f"g{rank}"])
        res = torch.zeros_like(g)
        outs = {}
        for i in range(3):
            mean, res = compressed_allreduce(g, None, res)
            outs[f"mean{i}"], outs[f"res{i}"] = mean.numpy(), res.numpy()
        np.savez(f"{work}/allreduce_{rank}.npz", **outs)
        # one data-parallel step on this rank's half of the batch
        cfg = reduced(get_config("granite-8b"))
        m = model.empty_model(cfg, "cpu")
        layout = convert.reference_layout(m)
        p0, _, _ = restore_checkpoint(f"{work}/p0", 0, layout, None)
        convert.fill_from_reference(p0, m)
        half = data["tokens"].shape[0] // world
        rows = slice(rank * half, (rank + 1) * half)
        batch = {k: torch.from_numpy(data[k][rows])
                 for k in ("tokens", "labels")}
        opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=10)
        step = make_dp_train_step(model.loss_fn, opt, compress=False)
        state = opt_init(dict(m.named_parameters()))
        m, state, _, loss, met = step(m, state, residual_init(m), batch)
        if rank == 0:
            save_checkpoint(f"{work}/dp", 1, convert.params_to_reference(m),
                            convert.opt_state_to_reference(m, state),
                            meta={"loss": float(loss),
                                  "grad_norm": float(met["grad_norm"])})
    print("RANK-OK", rank)
""")


def spawn_ranks(tmp_path, world, script=RANK):
    """Run ``script`` as ``world`` ranks meeting in a FileStore; each is
    killed after ``RANK_TIMEOUT_S``."""
    path = tmp_path / "rank.py"
    path.write_text(script)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(path), str(r), str(world),
                               str(tmp_path / "store"), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK-OK {r}" in out, out[-3000:]


def np_params():
    cfg = reduced(get_config(ARCH))
    jcfg = jreduced(jget_config(ARCH))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, perturb(jax.tree_util.tree_map(np.asarray, jp),
                              np.random.default_rng(11))


def stream_batch(cfg):
    b = SyntheticLMStream(DataConfig(seq_len=S, global_batch=B,
                                     vocab_size=cfg.vocab_size)).batch(0)
    return {k: v.numpy() for k, v in b.items()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """2 gloo ranks: the all-reduce's 3 steps and one DP step of reduced
    granite-8b, half the stream batch each."""
    work = tmp_path_factory.mktemp("ranks")
    cfg, jcfg, p0 = np_params()
    rng = np.random.default_rng(5)
    gs = [(rng.standard_normal(300) * s).astype(np.float32)
          for s in (1.0, 3.0)]
    batch = stream_batch(cfg)
    np.savez(work / "inputs.npz", g0=gs[0], g1=gs[1], **batch)
    save_checkpoint(str(work / "p0"), 0, p0, None)
    spawn_ranks(work, 2)
    return work, gs, cfg, jcfg, p0, batch


def test_compressed_allreduce_two_ranks_match_numpy(two_ranks):
    work, gs, *_ = two_ranks
    rs = [np.zeros_like(g) for g in gs]
    got = [np.load(work / f"allreduce_{r}.npz") for r in range(2)]
    for i in range(3):
        mean, rs = _np_allreduce(gs, rs)
        for r in range(2):
            np.testing.assert_array_equal(got[r][f"mean{i}"], mean)
            np.testing.assert_array_equal(got[r][f"res{i}"], rs[r])


def leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_updates_match(before, got, want, grads, lr=OPT.lr):
    """Each weight's update within 1e-5 x lr + 1e-4 x the reference's
    update + 2^-22 x |w| of the reference's, except where |g| is below
    1e-4 x max|g| (at most 2% of a leaf), where both updates are bounded
    by lr (1 + weight_decay |w|) (``test_torch_train_step.py``)."""
    assert sorted(got) == sorted(want)
    for name in want:
        du, dw = got[name] - before[name], want[name] - before[name]
        g = np.abs(grads[name])
        small = g <= 1e-4 * g.max()
        assert small.mean() <= 0.02, name
        tol = 1e-5 * lr + 1e-4 * np.abs(dw) + 2.0 ** -22 * np.abs(
            before[name])
        bad = (np.abs(du - dw) > tol) & ~small
        assert not bad.any(), (name, du[bad], dw[bad])
        bound = lr * (1 + OPT.weight_decay * np.abs(before[name]))
        assert (np.abs(du[small]) <= 1.01 * bound[small]).all(), name


def jax_dp_step(jcfg, p0, batch, compress):
    """The reference's ``make_dp_train_step`` on a one-device mesh: (the
    params after one step, the loss, the gradients of the whole batch)."""
    mesh = jax.make_mesh((1,), ("data",))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p, b):
        return jmodel.loss_fn(jcfg, p, b)

    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    grads = jax.grad(lambda p: loss(p, jb))(jp)
    step = jft.make_dp_train_step(loss, OPT, mesh, compress=compress)
    p1, _, _, jloss, _ = step(jp, jadamw.opt_init(jp),
                              jft.residual_init(jp), jb)
    return leaves(p1), float(jloss), leaves(grads)


def test_dp_step_two_ranks_matches_microbatch_and_the_reference(two_ranks):
    work, _, cfg, jcfg, p0, batch = two_ranks
    assert (batch["labels"] >= 0).all()     # no padding: equal token counts
    lay = convert.reference_layout(model.empty_model(cfg, "cpu"))
    from repro_torch.checkpoint import restore_checkpoint
    got_p, _, meta = restore_checkpoint(str(work / "dp"), 1, lay, None)
    got = leaves(got_p)
    # the port's microbatch-2 step on the whole batch, in every bit
    m = convert.params_from_reference(p0, cfg, device="cpu")
    state = opt_init(dict(m.named_parameters()))
    m, state, met = make_train_step(cfg, OPT, microbatch=2, device="cpu")(
        m, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert meta["loss"] == float(met["loss"])
    assert meta["grad_norm"] == float(met["grad_norm"])
    mb = leaves(convert.params_to_reference(m))
    for name in mb:
        np.testing.assert_array_equal(got[name], mb[name], err_msg=name)
    # the reference's DP step with the whole batch on one device
    want, jloss, grads = jax_dp_step(jcfg, p0, batch, compress=False)
    np.testing.assert_allclose(meta["loss"], jloss, rtol=1e-5)
    assert_updates_match(leaves(p0), got, want, grads)


@pytest.mark.parametrize("compress", [True, False])
def test_dp_step_world_one_matches_the_reference(group_of_one, compress):
    cfg, jcfg, p0 = np_params()
    batch = stream_batch(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    m = convert.params_from_reference(p0, cfg, device="cpu")
    state = opt_init(dict(m.named_parameters()))
    res = residual_init(m)
    assert all(r.dtype == torch.float32 and not r.any() for r in res.values())
    step = make_dp_train_step(model.loss_fn, OPT, compress=compress)
    m, state, res, loss, met = step(m, state, res, tb)
    assert int(state["step"]) == 1
    got = leaves(convert.params_to_reference(m))
    want, jloss, grads = jax_dp_step(jcfg, p0, batch, compress)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert_updates_match(leaves(p0), got, want, grads)
    if not compress:
        m2 = convert.params_from_reference(p0, cfg, device="cpu")
        s2 = opt_init(dict(m2.named_parameters()))
        m2, s2, met2 = make_train_step(cfg, OPT, device="cpu")(m2, s2, tb)
        assert float(met2["loss"]) == float(loss)
        for (n, a), (_, b) in zip(m.named_parameters(),
                                  m2.named_parameters()):
            assert torch.equal(a, b), n
    else:
        # what quantization lost is carried: |residual| <= scale / 2, the
        # scale max|g| / 127 (the reference's gradients, 1% slack)
        got_res = leaves(convert.params_to_reference(m, res))
        for name, r in got_res.items():
            bound = np.abs(grads[name]).max() / 254.0
            assert np.abs(r).max() <= 1.01 * bound + 1e-30, name
            assert np.abs(r).max() > 0 or bound == 0, name


# ---------------------------------------------------------------------------
# restore_resharded and rescale_state
# ---------------------------------------------------------------------------

def test_restore_resharded_reads_a_jax_checkpoint(tmp_path):
    params = {"layer": {"w": jnp.arange(6.0).reshape(2, 3) / 7.0,
                        "b": (jnp.arange(3.0) / 3.0).astype(jnp.bfloat16)},
              "emb": jnp.linspace(-1.0, 1.0, 8).reshape(2, 4)}
    opt = jadamw.opt_init(params)
    jsave(str(tmp_path), 3, params, opt, meta={"arch": "x"})
    mesh = subgrid_mesh(2, devices=["cpu"] * 2)

    def spec_fn(tree):
        return tree_map(lambda _: NamedSharding(mesh, PartitionSpec()), tree)

    # tensor templates: each leaf back in its template's dtype
    tmpl = {"layer": {"w": torch.zeros(2, 3),
                      "b": torch.zeros(3, dtype=torch.bfloat16)},
            "emb": torch.zeros(2, 4)}
    otmpl = {"m": tmpl, "v": tmpl, "step": torch.zeros((), dtype=torch.int32)}
    p, o, meta = restore_resharded(str(tmp_path), 3, tmpl, otmpl, mesh,
                                   spec_fn)
    assert meta == {"step": 3, "arch": "x"}
    assert p["layer"]["b"].dtype == torch.bfloat16
    for got, want in ((p["layer"]["w"], params["layer"]["w"]),
                      (p["emb"], params["emb"]),
                      (p["layer"]["b"].float(),
                       params["layer"]["b"].astype(jnp.float32))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(o["step"]) == 0 and o["m"]["emb"].dtype == torch.float32
    # numpy templates (a layout of zeros): the leaves become tensors
    lay = tree_map(lambda _: 0, tmpl)
    p2, _, _ = restore_resharded(str(tmp_path), 3, lay, None, mesh,
                                 lambda t: tree_map(lambda _: "cpu", t))
    assert isinstance(p2["emb"], torch.Tensor)
    np.testing.assert_array_equal(p2["emb"].numpy(),
                                  np.asarray(params["emb"]))
    assert p2["layer"]["b"].dtype == torch.float32   # stored as fp32


def test_rescale_state_places_model_and_state():
    cfg = reduced(get_config(ARCH))
    m = model.init_params(cfg, 0, device="cpu")
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    ids = {n: id(p) for n, p in m.named_parameters()}
    state = opt_init(dict(m.named_parameters()))
    mesh = subgrid_mesh(2, devices=["cpu"] * 2)
    seen = []

    def spec_fn(tree, mesh_):
        seen.append(mesh_)
        return tree_map(lambda _: NamedSharding(mesh_, PartitionSpec()), tree)

    m2, s2 = rescale_state(m, state, mesh, spec_fn)
    assert m2 is m and seen == [mesh, mesh]
    for n, p in m.named_parameters():
        assert id(p) == ids[n] and torch.equal(p, before[n])
    assert torch.equal(s2["step"], state["step"])
    params = {n: p.detach() for n, p in m.named_parameters()}
    p3, _ = rescale_state(params, state, mesh, spec_fn)
    assert set(p3) == set(params)


# ---------------------------------------------------------------------------
# least-loaded scheduling
# ---------------------------------------------------------------------------

def test_load_scheduling_matches_the_reference_picks():
    """Both pools under ``"load"`` with ``busy`` faked from one table:
    the first idle executor, else the next round robin."""
    rng = np.random.default_rng(2)
    table = rng.random((40, 3)) < 0.6
    table[5] = table[6] = True                 # all busy: round robin

    def picks(pool):
        row = {"i": 0}
        for k, e in enumerate(pool.executors):
            e.busy = (lambda k=k: bool(table[row["i"], k]))
        out = []
        for i in range(len(table)):
            row["i"] = i
            out.append(pool.executors.index(pool.get()))
        return out

    got = picks(ExecutorPool(3, device="cpu", scheduling="load"))
    want = picks(JExecutorPool(3, scheduling="load"))
    assert got == want
    rr = ExecutorPool(3, device="cpu")
    assert [rr.executors.index(rr.get()) for _ in range(5)] == \
        [0, 1, 2, 0, 1]
    with pytest.raises(ValueError, match="unknown scheduling"):
        ExecutorPool(2, device="cpu", scheduling="fastest")
