"""The ``ServingEngine`` on the six attention-stack architectures of
tests/test_torch_families.py: token for token against the reference's
engine, equal to each request decoded alone, a reused slot of
seamless-m4t (its fresh cross K and V not zero) free of crosstalk, and
the ``serve`` entry point on each.

The weights are ``test_torch_families.pair``'s: the reference's
``init_params`` with seeded random norms, biases and gates, carried across.
Both engines feed vlm and audio the same zero stub memory.  fp32 on the
CPU, where the port runs its kernels' plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from test_torch_families import ARCHS, pair  # noqa: E402

PROMPTS = [[5, 7, 9], [11, 3], [2, 2, 2, 2], [8], [13, 21], [1, 2, 3]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def solo_decode(m, prompt, n_new, max_len=64):
    """One request alone through the port's bucket-1 ``decode_step``,
    against the engine's stub memory."""
    cache = model.init_cache(m, 1, max_len)
    for t in prompt[:-1]:
        _, cache = model.decode_step(m, cache, torch.tensor([[t]]))
    tok, out = prompt[-1], []
    for _ in range(n_new):
        lg, cache = model.decode_step(m, cache, torch.tensor([[tok]]))
        tok = int(torch.argmax(lg[0]))
        out.append(tok)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    cfg, m, jcfg, jp = pair(arch)
    jeng = JServingEngine(jcfg, jp, max_batch=4, max_len=64)
    eng = ServingEngine(cfg, m, max_batch=4, max_len=64, device="cpu")
    jreqs = [JRequest(i, p, max_new_tokens=4) for i, p in enumerate(PROMPTS)]
    reqs = [Request(i, p, max_new_tokens=4) for i, p in enumerate(PROMPTS)]
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    jeng.run()
    eng.run()
    for jr, r in zip(jreqs, reqs):
        assert r.done and jr.done
        assert r.output == jr.output, r.rid
    assert eng.stats["launches"] == jeng.stats["launches"]
    assert eng.stats["aggregated_hist"] == jeng.stats["aggregated_hist"]
    assert eng.stats["tokens"] == jeng.stats["tokens"]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_sequential(arch):
    cfg, m = pair(arch)[:2]
    eng = ServingEngine(cfg, m, max_batch=4, max_len=64, device="cpu")
    reqs = [Request(i, p, max_new_tokens=4) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert r.done
        assert r.output == solo_decode(m, r.prompt, 4), r.rid


def test_seamless_slot_reuse_no_crosstalk():
    """With a nonzero LayerNorm bias the encoded stub memory, and so the
    fresh cross K and V, is not zero; a slot freed and reused (and the
    spare slot pad lanes write into) decodes its new request exactly as
    that request decodes alone."""
    cfg, m = pair("seamless-m4t-large-v2")[:2]
    eng = ServingEngine(cfg, m, max_batch=2, max_len=32, device="cpu")
    assert sorted(eng._fresh) == ["cross_k", "cross_v"]
    fresh = {n: t.clone() for n, t in eng.cache.items()}
    first = [Request(0, [3, 1, 4], max_new_tokens=3),
             Request(1, [1, 5], max_new_tokens=5)]
    second = [Request(2, [9, 2, 6], max_new_tokens=4),
              Request(3, [7], max_new_tokens=2)]
    for r in first + second:
        eng.submit(r)
    eng.run()
    for r in first + second:
        assert r.output == solo_decode(m, r.prompt, r.max_new_tokens,
                                       max_len=32), r.rid
    # the cross K and V are never written; a slot reset restores the rest
    for name in ("cross_k", "cross_v"):
        assert torch.equal(eng.cache[name], fresh[name])
    eng._zero_slot_states(0)
    assert not bool(eng.cache["k"][:, 0].any())
    assert torch.equal(eng.cache["cross_k"][:, 0], fresh["cross_k"][:, 0])
    assert float(np.abs(fresh["cross_k"].numpy()).max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_cpu(arch, capsys):
    """``python -m repro_torch.serve --arch <arch> --reduced --device
    cpu`` serves every request, with no kernel launched on the CPU."""
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--requests", "4", "--max-batch", "4", "--max-len", "16",
                "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "served 4/4 requests, 12 tokens" in out
    assert "decode_attention_cuda 0, grouped_gemm_cuda 0" in out
