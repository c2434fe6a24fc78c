"""The port's AdamW, schedule, clipping and int8 codec against the JAX
reference (``repro.optim``), and the reference's own optimizer checks
(``tests/test_substrate.py:30``-``:70``) as port tests.

``opt_update`` runs 5 steps from the same weights, gradients and state on
both sides, in fp32 and with bf16 weights; gradients large enough that
the clipping engages on some steps and not on others.  fp32 results agree
within rtol 1e-6 and atol 1e-7 x max|leaf| (the two packages round pow,
sqrt and the norm's sum in their own order); a bf16 weight within one
bf16 ulp (rtol 2^-8) of the reference's."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402

from repro_torch.optim import (  # noqa: E402
    OptConfig, clip_by_global_norm, cosine_lr, global_norm, int8_compress,
    int8_decompress, opt_init, opt_update,
)

SHAPES = {"a": (7, 5), "b": (13,), "c": ()}
CFG = OptConfig(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1,
                clip_norm=1.0)


def _np_tree(rng, scale=1.0):
    return {k: np.asarray(scale * rng.standard_normal(s), np.float32)
            for k, s in SHAPES.items()}


def _assert_close(got, want, bf16=False, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if bf16:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0,
                                   err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-7 * float(np.abs(want).max()),
                                   err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_opt_update_matches_the_reference_over_5_steps(dtype):
    rng = np.random.default_rng(0)
    p0 = _np_tree(rng)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    params = {k: torch.from_numpy(v.copy()).to(tdt) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    state, jstate = opt_init(params), jadamw.opt_init(jparams)
    assert all(m.dtype == torch.float32 for m in state["m"].values())
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    clipped = []
    for step in range(5):
        g = _np_tree(rng, scale=(0.05 if step % 2 else 3.0))
        grads = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        jgrads = {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
        params, state, met = opt_update(grads, state, params, CFG)
        jparams, jstate, jmet = jadamw.opt_update(jgrads, jstate, jparams,
                                                  CFG)
        clipped.append(float(met["grad_norm"]) > CFG.clip_norm)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        _assert_close(met["grad_norm"], jmet["grad_norm"], msg="gnorm")
        _assert_close(met["lr"], jmet["lr"], msg="lr")
        for k in SHAPES:
            assert params[k].dtype == tdt
            _assert_close(params[k].float(), jparams[k].astype(jnp.float32),
                          bf16=dtype == "bfloat16", msg=f"{k} step {step}")
            _assert_close(state["m"][k], jstate["m"][k], msg=f"m {k}")
            _assert_close(state["v"][k], jstate["v"][k], msg=f"v {k}")
    assert any(clipped) and not all(clipped)


def test_cosine_lr_matches_the_reference_at_every_step():
    """Within rtol 1e-6 and atol 1e-6 x lr: near the schedule's end 1 +
    cos(pi t) cancels, and the last ulp of each package's fp32 cos shows
    at a few times 1e-5 of the tiny result (step 49 of 50: 3.65397e-06
    against 3.65388e-06), 3e-8 of the peak lr."""
    cfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=50)
    for step in range(cfg.total_steps + 1):
        want = jadamw.cosine_lr(cfg, jnp.int32(step))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = cosine_lr(cfg, s)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-6 * cfg.lr, err_msg=str(step))


def test_global_norm_and_clipping_match_the_reference():
    rng = np.random.default_rng(1)
    for scale in (0.01, 5.0):
        g = _np_tree(rng, scale)
        tree = {k: torch.from_numpy(v) for k, v in g.items()}
        jtree = {k: jnp.asarray(v) for k, v in g.items()}
        _assert_close(global_norm(tree), jadamw.global_norm(jtree))
        got, norm = clip_by_global_norm(tree, 1.0)
        want, jnorm = jadamw.clip_by_global_norm(jtree, 1.0)
        _assert_close(norm, jnorm)
        for k in SHAPES:
            assert got[k].dtype == torch.float32
            _assert_close(got[k], want[k], msg=k)


def test_int8_compress_gives_the_references_q_and_scale():
    rng = np.random.default_rng(2)
    for g in (rng.standard_normal(1000).astype(np.float32),
              np.linspace(-2.54, 2.54, 255, dtype=np.float32),   # ties
              np.zeros(16, np.float32)):
        q, scale = int8_compress(torch.from_numpy(g))
        jq, jscale = jcomp.int8_compress(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        np.testing.assert_array_equal(
            int8_decompress(q, scale).numpy(),
            np.asarray(jcomp.int8_decompress(jq, jscale)))


# ---------------------------------------------------------------------------
# the reference's own checks (tests/test_substrate.py:30-:70), as port tests
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt_init(params)
    cfg = OptConfig(lr=0.2, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, clip_norm=100.0)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_cosine_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(cosine_lr(cfg, 0)) == pytest.approx(0.1)
    assert float(cosine_lr(cfg, 9)) == pytest.approx(1.0)
    assert float(cosine_lr(cfg, 55)) == pytest.approx(0.5, abs=0.05)
    assert float(cosine_lr(cfg, 99)) < 0.01


def test_grad_clip():
    tree = {"a": torch.tensor([3.0, 4.0])}
    assert float(global_norm(tree)) == pytest.approx(5.0)
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0)
    assert float(norm) == pytest.approx(5.0)


def test_adamw_bf16_params_fp32_state():
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = opt_init(params)
    assert state["m"]["w"].dtype == torch.float32
    grads = {"w": torch.full((4,), 0.1)}
    new_p, new_s, _ = opt_update(grads, state, params, OptConfig())
    assert new_p["w"].dtype == torch.bfloat16


def test_int8_roundtrip_error_bounded():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    q, scale = int8_compress(g)
    back = int8_decompress(q, scale)
    assert float((back - g).abs().max()) <= float(scale) * 0.5 + 1e-6


def test_opt_update_keeps_leaf_updates_in_pieces(monkeypatch):
    """A leaf larger than ``CHUNK`` is updated piece by piece with the
    same result as in one piece."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    whole = opt_update({"w": g}, opt_init({"w": p}), {"w": p.clone()}, CFG)
    monkeypatch.setattr(adamw, "CHUNK", 64)
    pieces = opt_update({"w": g}, opt_init({"w": p}), {"w": p.clone()}, CFG)
    assert torch.equal(whole[0]["w"], pieces[0]["w"])
    assert torch.equal(whole[1]["m"]["w"], pieces[1]["m"]["w"])
    assert torch.equal(whole[2]["grad_norm"], pieces[2]["grad_norm"]) or \
        math.isclose(float(whole[2]["grad_norm"]),
                     float(pieces[2]["grad_norm"]), rel_tol=1e-6)
