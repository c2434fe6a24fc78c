"""The port's ``make_train_step`` and ``launch.train`` against the JAX
reference: one step at ``microbatch`` 0, 2 and 4 against
``jax.jit(make_train_step(...))`` (the loss and every weight after the
step); microbatch gradients accumulated in fp32 with bf16 weights;
``train()`` lowering the loss by the reference's bar; a SIGKILLed run
resumed bit for bit; training checkpoints exchanged with the JAX
``save_checkpoint`` / ``restore_checkpoint`` bit for bit; the CLI.

granite-8b reduced (fp32 unless said, 2 layers where the reference's own
test cuts it so) with its norms perturbed; batches are numpy draws from a
seed.  After one AdamW step a weight moves by about lr x g / |g|, so the
weights are compared as updates: each within 1e-5 x lr + 1e-4 x the
reference's update + 2^-22 x |w| (two fp32 ulps of the weight, where the
two sums round) of the reference's update, except where |g| is below 1e-4 x max|g|, ten
times the gradients' own tolerance (``test_torch_train.py``), where the
two packages' gradients agree in absolute terms but not in sign or
relative size; there (at most 2% of a leaf's elements) the two updates
are each bounded by lr (1 + weight_decay |w|), which is checked."""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402,E501
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import convert, model  # noqa: E402
from repro_torch.optim import OptConfig, opt_init  # noqa: E402

from test_torch_families import perturb  # noqa: E402

ARCH = "granite-8b"
B, S = 4, 16
OPT = OptConfig(lr=3e-4, warmup_steps=2, total_steps=10)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_params(dtype="float32", n_layers=None):
    cfg = reduced(get_config(ARCH)).replace(dtype=dtype)
    jcfg = jreduced(jget_config(ARCH)).replace(dtype=dtype)
    if n_layers:
        cfg, jcfg = (c.replace(n_layers=n_layers) for c in (cfg, jcfg))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, perturb(jax.tree_util.tree_map(np.asarray, jp),
                              np.random.default_rng(11))


def np_batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("microbatch", [0, 2, 4])
def test_train_step_matches_the_reference(microbatch):
    cfg, jcfg, p0 = np_params()
    nb = np_batch(cfg)
    jstep = jax.jit(jmake_train_step(jcfg, OPT, microbatch=microbatch))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jp1, js1, jmet = jstep(jp, jadamw.opt_init(jp),
                           {k: jnp.asarray(v) for k, v in nb.items()})
    jg = jax.grad(lambda p: jmodel.loss_fn(jcfg, p, {
        k: jnp.asarray(v) for k, v in nb.items()}))(jp)

    m = convert.params_from_reference(p0, cfg, device="cpu")
    state = opt_init(dict(m.named_parameters()))
    step = make_train_step(cfg, OPT, microbatch=microbatch, device="cpu")
    m, state, met = step(m, state,
                         {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    assert int(state["step"]) == 1
    before, got = leaves(p0), leaves(convert.params_to_reference(m))
    want, grads = leaves(jp1), leaves(jg)
    assert sorted(got) == sorted(want)
    for name in want:
        du, dw = got[name] - before[name], want[name] - before[name]
        g = np.abs(grads[name])
        small = g <= 1e-4 * g.max()
        assert small.mean() <= 0.02, name
        tol = 1e-5 * OPT.lr + 1e-4 * np.abs(dw) + 2.0 ** -22 * np.abs(
            before[name])
        bad = (np.abs(du - dw) > tol) & ~small
        assert not bad.any(), (name, du[bad], dw[bad])
        bound = OPT.lr * (1 + OPT.weight_decay * np.abs(before[name]))
        assert (np.abs(du[small]) <= 1.01 * bound[small]).all(), name
    got_m = leaves(convert.opt_state_to_reference(m, state)["m"])
    for name, a in leaves(js1["m"]).items():
        np.testing.assert_allclose(got_m[name], a, rtol=1e-4,
                                   atol=1e-5 * np.abs(a).max(), err_msg=name)


def test_microbatch_gradients_accumulate_in_fp32():
    """bf16 weights, microbatch 2: the step's first moment equals (1 -
    beta1) x the clipped mean of the two microbatches' bf16 gradients
    added into fp32 zeros, in every bit; the same sum taken in bf16 (two
    ``.backward()`` calls into ``.grad``) differs."""
    cfg, _, p0 = np_params("bfloat16")
    batch = {k: torch.from_numpy(v) for k, v in np_batch(cfg).items()}
    m = convert.params_from_reference(p0, cfg,
                                      device="cpu").requires_grad_(True)
    names, leaves_ = zip(*m.named_parameters())
    parts = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
             for i in range(2)]
    per_mb = [torch.autograd.grad(model.loss_fn(m, part), leaves_,
                                  allow_unused=True, materialize_grads=True)
              for part in parts]
    fp32 = [(torch.zeros(p.shape) + a + b) / 2
            for p, a, b in zip(leaves_, *per_mb)]
    bf16 = [((a + b) / 2).float() for a, b in zip(*per_mb)]

    def first_moment(grads):
        from repro_torch.optim.adamw import _clip_scale, global_norm
        scale = _clip_scale(global_norm(grads), OPT.clip_norm)
        return [(1 - OPT.beta1) * (g * scale) for g in grads]

    state = opt_init(dict(m.named_parameters()))
    step = make_train_step(cfg, OPT, microbatch=2, device="cpu")
    m, state, _ = step(m, state, batch)
    got = [state["m"][n] for n in names]
    want, wrong = first_moment(fp32), first_moment(bf16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not all(torch.equal(a, b) for a, b in zip(got, wrong))


def test_train_lowers_the_loss_on_a_tiny_model():
    """The reference's bar (``tests/test_models.py:160``): granite-8b
    reduced to 2 layers, 30 steps of seq 64, batch 8, lr 3e-3, warmup 5,
    50 total steps; the mean of the last 5 losses below the mean of the
    first 5 by 0.2."""
    _, _, losses = train_mod.train(ARCH, 30, 64, 8, True, lr=3e-3,
                                   total_steps=50, n_layers=2,
                                   device="cpu")
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


RESUME_CHILD = """
import os, signal, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import train as t
save = t.save_state
def save_then_die(ckpt_dir, step, *args, **kw):
    path = save(ckpt_dir, step, *args, **kw)
    if step == 2:
        os.kill(os.getpid(), signal.SIGKILL)
    return path
t.save_state = save_then_die
t.train(sys.argv[1], 4, 16, 4, True, sys.argv[2], save_every=1,
        microbatch=2, device="cpu")
"""


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-moe-a2.7b"])
def test_killed_run_resumes_bit_identical(arch, tmp_path):
    """A child process trains 4 steps with a checkpoint after each and is
    SIGKILLed after checkpoint 2; the run resumed from it equals the
    uninterrupted one in every weight, ``m``, ``v`` and ``step``."""
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", RESUME_CHILD, arch, ckpt],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert train_mod.latest_step(ckpt) == 2
    resumed, r_state, losses = train_mod.train(
        arch, 4, 16, 4, True, ckpt, save_every=1, microbatch=2,
        device="cpu")
    assert len(losses) == 2
    straight, s_state, _ = train_mod.train(arch, 4, 16, 4, True,
                                           microbatch=2, device="cpu")
    for (name, a), (_, b) in zip(resumed.named_parameters(),
                                 straight.named_parameters()):
        assert torch.equal(a, b), name
    for key in ("m", "v"):
        for name in s_state[key]:
            assert torch.equal(r_state[key][name], s_state[key][name]), name
    assert int(r_state["step"]) == int(s_state["step"]) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_checkpoints_cross_between_the_packages(dtype, tmp_path):
    """A port checkpoint restored by the JAX ``restore_checkpoint``, and a
    JAX checkpoint restored by the port, both bit for bit."""
    cfg, jcfg, p0 = np_params(dtype)
    m = convert.params_from_reference(p0, cfg, device="cpu")
    rng = np.random.default_rng(7)
    state = opt_init(dict(m.named_parameters()))
    for key in ("m", "v"):
        for t in state[key].values():
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape))
                                     .astype(np.float32)))
    state["step"] = torch.tensor(7, dtype=torch.int32)
    train_mod.save_state(str(tmp_path / "port"), 7, m, state)

    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    jp_r, js_r, meta = jrestore(str(tmp_path / "port"), 7, jp,
                                jadamw.opt_init(jp))
    assert meta == {"step": 7, "arch": cfg.name}
    want_p = leaves(convert.params_to_reference(m))
    want_s = convert.opt_state_to_reference(m, state)
    for name, a in leaves(jp_r).items():
        assert a.dtype == jnp.dtype(dtype), name
        np.testing.assert_array_equal(a.astype(np.float32), want_p[name])
    for key in ("m", "v"):
        got = leaves(js_r[key])
        for name, a in leaves(want_s[key]).items():
            np.testing.assert_array_equal(got[name], a)
    assert int(js_r["step"]) == 7

    # the reverse: the JAX package writes, the port restores
    jstate = jax.tree_util.tree_map(lambda a: a * 2, js_r)
    jsave(str(tmp_path / "jax"), 9, jp_r, jstate, meta={"arch": cfg.name})
    m2 = convert.params_from_reference(
        jax.tree_util.tree_map(np.asarray, jmodel.init_params(
            jcfg, jax.random.PRNGKey(2))), cfg, device="cpu")
    state2, meta2 = train_mod.restore_state(str(tmp_path / "jax"), 9, m2)
    assert meta2 == {"step": 9, "arch": cfg.name}
    for name, a in leaves(convert.params_to_reference(m2)).items():
        np.testing.assert_array_equal(
            a, leaves(jp_r)[name].astype(np.float32))
    for key in ("m", "v"):
        got = leaves(convert.opt_state_to_reference(m2, state2)[key])
        for name, a in leaves(jstate[key]).items():
            np.testing.assert_array_equal(got[name], a)
    assert state2["step"].dtype == torch.int32 and int(state2["step"]) == 14


def test_cli_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "3"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "final loss" in proc.stdout and "device=cpu" in proc.stdout


def test_train_and_its_step_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduced(get_config(ARCH))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, OPT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.train(ARCH, 1, 16, 2, True)


def _wrapper_calls(x):
    """Every CUDA kernel wrapper called on ``x`` (B 2, F 5, P 14 slots)."""
    from repro_torch.kernels import (
        decode_attention, gravity, grouped_gemm, hydro_rhs, hydro_split,
    )
    kw = dict(gamma=1.4, ghost=3, subgrid=8)
    h = torch.ones(2)
    cache = torch.zeros(2, 4, 1, 8)
    lens = torch.ones(2, dtype=torch.int32)
    return {
        "hydro_rhs": lambda: hydro_rhs.hydro_rhs_cuda(x, h=0.1, **kw),
        "hydro_rhs_lane": lambda: hydro_rhs.hydro_rhs_lane_cuda(
            x, h=0.1, **kw),
        "hydro_reconstruct": lambda: hydro_split.hydro_reconstruct_cuda(x),
        "hydro_flux": lambda: hydro_split.hydro_flux_cuda(x, h=0.1, **kw),
        "gravity": lambda: gravity.gravity_cuda(x, h, ghost=3, subgrid=8),
        "decode_attention": lambda: decode_attention.decode_attention_cuda(
            x[:, 0, 0, :1, :8], cache, cache, lens),
        "grouped_gemm": lambda: grouped_gemm.grouped_gemm_cuda(
            x[:, 0, 0], x[:, 0, 0].transpose(1, 2).contiguous(),
            torch.ones(2, dtype=torch.int32)),
    }


def test_kernel_wrappers_refuse_inputs_that_need_gradients():
    """Each CUDA wrapper raises before any build or launch when autograd
    records and an input requires a gradient, naming the kernel and
    ``ops.PLAIN_LM``; under ``torch.no_grad()`` the same call reaches the
    wrapper's usual device check instead."""
    x = torch.zeros(2, 5, 14, 14, 14, requires_grad=True)
    for name, call in _wrapper_calls(x).items():
        with pytest.raises(RuntimeError, match=rf"the {name} kernel has no "
                           r"backward.*ops\.PLAIN_LM"):
            call()
        with torch.no_grad():
            with pytest.raises(ValueError, match="CUDA tensor"):
                call()


def test_a_trainable_model_serves_without_autograd():
    """A model whose weights require gradients: ``make_serve_step`` and
    ``make_prefill_step`` record no graph and give the frozen model's
    results; the engine serves it token for token as the frozen one."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.serving.engine import Request, ServingEngine
    cfg, _, p0 = np_params()
    frozen = convert.params_from_reference(p0, cfg, device="cpu")
    live = convert.params_from_reference(p0, cfg,
                                         device="cpu").requires_grad_(True)
    tokens = torch.from_numpy(np_batch(cfg)["tokens"])
    with torch.no_grad():
        want = model.forward(frozen, {"tokens": tokens})[:, -1]
    got = make_prefill_step(cfg)(live, {"tokens": tokens})
    assert not got.requires_grad and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    cache = model.init_cache(frozen, B, 8)
    logits, _ = make_serve_step(cfg)(live, cache, {"tokens": tokens[:, :1]})
    assert logits.grad_fn is None
    outs = []
    for m in (frozen, live):
        eng = ServingEngine(cfg, m, max_batch=4, max_len=32, device="cpu")
        reqs = [Request(rid=i, prompt=[3 + i, 7, 11], max_new_tokens=4)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1] and all(len(o) == 4 for o in outs[0])
