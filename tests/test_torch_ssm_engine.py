"""The ``ServingEngine`` on the ssm and hybrid architectures of
tests/test_torch_ssm.py (xlstm-125m, zamba2-2.7b): token for token against
the reference's engine, equal to each request decoded alone, a reused
slot equal to a fresh one (mLSTM's stabiliser back at -1e30 and sLSTM's
``n`` back at ones, not zero), and the ``serve`` entry point on each.

The weights are ``test_torch_ssm.pair``'s: the reference's
``init_params`` with seeded random norms, biases and gate biases, carried
across.  fp32 on the CPU, where the port runs its kernels' plain
versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from test_torch_ssm import ARCHS, pair  # noqa: E402

PROMPTS = [[5, 7, 9], [11, 3], [2, 2, 2, 2], [8], [13, 21], [1, 2, 3]]
# each family's leaves whose fresh values are not zero
NONZERO_FRESH = {"xlstm-125m": ["mlstm_m", "slstm_n"], "zamba2-2.7b": []}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def solo_decode(m, prompt, n_new, max_len=64):
    """One request alone through the port's bucket-1 ``decode_step`` from
    a fresh cache."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slot_equals_a_fresh_one(arch):
    """Two slots, four requests: each slot is freed and reused (and the
    spare slot takes pad lanes), yet every request decodes exactly as it
    does alone from a fresh cache; a slot reset afterwards holds a fresh
    cache's values in every leaf, the -1e30 stabiliser and the unit ``n``
    included."""
    cfg, m = pair(arch)[:2]
    eng = ServingEngine(cfg, m, max_batch=2, max_len=32, device="cpu")
    assert sorted(eng._fresh) == NONZERO_FRESH[arch]
    reqs = [Request(0, [3, 1, 4], max_new_tokens=3),
            Request(1, [1, 5], max_new_tokens=5),
            Request(2, [9, 2, 6], max_new_tokens=4),
            Request(3, [7], max_new_tokens=2)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert r.output == solo_decode(m, r.prompt, r.max_new_tokens,
                                       max_len=32), r.rid
    fresh = model.init_cache(m, 2, 32)
    for slot in (0, 1):
        assert any(bool((eng.cache[name][:, slot]
                         != fresh[name][:, slot]).any())
                   for name in fresh if name != "len"), slot
        eng._zero_slot_states(slot)
    for name, t in fresh.items():
        if name != "len":
            assert torch.equal(eng.cache[name], t), name
    if cfg.family == "ssm":
        assert float(eng.cache["mlstm_m"].max()) == float(np.float32(-1e30))
        assert float(eng.cache["slstm_n"].min()) == 1.0


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
