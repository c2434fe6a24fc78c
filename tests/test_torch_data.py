"""The port's synthetic training stream and batch specs: determinism by
``(seed, step)``, shifted labels, one batch whichever device is asked for,
the stream's stated statistics, and ``make_batch_specs`` against the JAX
reference's shapes and dtypes.

The reference draws with ``jax.random``, whose bits the port does not
reproduce, so the stream is held to its stated properties instead: the
unigram draws against Zipf(1.2) and the share of positions that follow the
successor table, each within 5 standard deviations of its expectation
over the draws of 64 steps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.pipeline import make_batch_specs as jmake_batch_specs  # noqa: E402,E501

from repro_torch.configs import ALL_SHAPES, ARCHS, get_config  # noqa: E402
from repro_torch.data import (  # noqa: E402
    DataConfig, SyntheticLMStream, make_batch_specs,
)
from repro_torch.data.pipeline import N_SUCCESSORS  # noqa: E402

CFG = DataConfig(seq_len=64, global_batch=8, vocab_size=256)
SIGMAS = 5.0


def test_batches_are_determined_by_seed_and_step():
    a, b = SyntheticLMStream(CFG), SyntheticLMStream(CFG)
    for step in (0, 1, 17):
        x, y = a.batch(step), b.batch(step)
        assert torch.equal(x["tokens"], y["tokens"])
        assert torch.equal(x["labels"], y["labels"])
    assert not torch.equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    other = SyntheticLMStream(DataConfig(seq_len=64, global_batch=8,
                                         vocab_size=256, seed=1))
    assert not torch.equal(a.batch(0)["tokens"], other.batch(0)["tokens"])
    assert not torch.equal(a.succ, other.succ)


def test_labels_are_the_tokens_shifted_with_the_wrap():
    batch = SyntheticLMStream(CFG).batch(3)
    tok, lab = batch["tokens"], batch["labels"]
    assert tok.dtype == lab.dtype == torch.int32
    assert tok.shape == lab.shape == (8, 64)
    assert torch.equal(lab[:, :-1], tok[:, 1:])
    assert torch.equal(lab[:, -1], tok[:, 0])
    assert int(tok.min()) >= 0 and int(tok.max()) < 256


def test_same_batch_whichever_device():
    """The draw happens on the CPU whatever the device: the batch asked
    for on a device is the CPU batch moved there (here: the CPU named two
    ways, and the meta device's shapes and dtypes; the card in
    ``test_torch_cuda.py``)."""
    s = SyntheticLMStream(CFG)
    ref = s.batch(5)
    for dev in ("cpu", torch.device("cpu")):
        got = s.batch(5, dev)
        assert all(torch.equal(got[k], ref[k]) for k in ref)
    meta = s.batch(5, "meta")
    for k in ref:
        assert meta[k].device.type == "meta"
        assert meta[k].shape == ref[k].shape and meta[k].dtype == ref[k].dtype


def test_tokens_follow_the_draws():
    """Each token is its position's unigram draw, or, where ``follow``,
    the picked successor of the unigram draw one position back."""
    s = SyntheticLMStream(CFG)
    d, tok = s.draw(9), s.batch(9)["tokens"].long()
    prev = torch.roll(d["base"], 1, dims=1)
    want = torch.where(d["follow"], s.succ[prev, d["pick"]], d["base"])
    assert torch.equal(tok, want)
    assert s.succ.shape == (256, N_SUCCESSORS)


def test_unigram_is_zipf_and_half_the_positions_follow():
    s = SyntheticLMStream(CFG)
    draws = [s.draw(step) for step in range(64)]
    base = torch.cat([d["base"].reshape(-1) for d in draws]).numpy()
    follow = torch.cat([d["follow"].reshape(-1) for d in draws]).numpy()
    n = base.size
    ranks = np.arange(1, 257, dtype=np.float64)
    p = ranks ** -1.2
    p /= p.sum()
    counts = np.bincount(base, minlength=256)
    # the 32 most likely tokens one by one, the rest as one bin
    for t in range(32):
        sd = np.sqrt(n * p[t] * (1 - p[t]))
        assert abs(counts[t] - n * p[t]) < SIGMAS * sd, t
    rest = p[32:].sum()
    assert abs(counts[32:].sum() - n * rest) < \
        SIGMAS * np.sqrt(n * rest * (1 - rest))
    share = follow.mean()
    assert abs(share - 0.5) < SIGMAS * np.sqrt(0.25 / n), share


def _jdtype(d):
    return {jnp.dtype(jnp.int32): torch.int32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.float32): torch.float32}[jnp.dtype(d)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape, jshape in zip(ALL_SHAPES, JSHAPES):
        for extra in (torch.bfloat16, torch.float32):
            jextra = jnp.bfloat16 if extra == torch.bfloat16 else jnp.float32
            got = make_batch_specs(cfg, shape, extra)
            want = jmake_batch_specs(jcfg, jshape, jextra)
            assert sorted(got) == sorted(want), (arch, shape.name)
            for k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape), k
                assert got[k].dtype == _jdtype(want[k].dtype), k
