"""The serving kernels' plain versions against the JAX reference.

The same inputs, made with numpy from a seed, go through the reference's
Pallas kernels (in interpret mode, as tests/test_kernels.py runs them), its
jnp oracles (``repro.kernels.ref``) and the port's plain PyTorch versions,
at the reference's kernel tolerances: decode attention 2e-5 in fp32 and
2e-2 in bf16, the grouped GEMM 1e-5 in fp32 and 2e-2 in bf16.  bf16 inputs
are rounded from the same fp32 draws on both sides.  The CUDA kernels are
held to these plain versions on the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jda  # noqa: E402
from repro.kernels.grouped_gemm import grouped_gemm as jgg  # noqa: E402

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import grouped_gemm as gg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(a, bf16=False):
    """One fp32 numpy draw as a JAX array and a torch tensor, rounded to
    bf16 on both sides when asked."""
    a = np.asarray(a, np.float32)
    j, t = jnp.asarray(a), torch.from_numpy(a.copy())
    if bf16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def attention_inputs(seed, b, hq, hkv, d, s, bf16=False):
    rng = np.random.default_rng(seed)
    q = both(rng.standard_normal((b, hq, d)), bf16)
    k = both(rng.standard_normal((b, s, hkv, d)), bf16)
    v = both(rng.standard_normal((b, s, hkv, d)), bf16)
    return q, k, v


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (12, 4)])
@pytest.mark.parametrize("s,bs", [(512, 128), (1024, 512)])
def test_decode_attention_plain_matches_jax(hq, hkv, s, bs):
    b, d = 3, 64
    (jq, q), (jk, k), (jv, v) = attention_inputs(hq * s, b, hq, hkv, d, s)
    lens = np.random.default_rng(s).integers(1, s + 1, b).astype(np.int32)
    got = da.decode_attention_plain(q, k, v, torch.from_numpy(lens))
    jl = jnp.asarray(lens)
    close(got, jda(jq, jk, jv, jl, bs=bs), 2e-5)
    close(got, jref.decode_attention_ref(jq, jk, jv, jl), 2e-5)
    assert torch.equal(ops.decode_attention(q, k, v, torch.from_numpy(lens)),
                       got)


def test_decode_attention_plain_bf16():
    (jq, q), (jk, k), (jv, v) = attention_inputs(1, 2, 4, 2, 64, 256,
                                                 bf16=True)
    lens = np.array([256, 33], np.int32)
    got = da.decode_attention_plain(q, k, v, torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    jl = jnp.asarray(lens)
    close(got, jda(jq, jk, jv, jl, bs=128), 2e-2)
    close(got, jref.decode_attention_ref(jq, jk, jv, jl), 2e-2)


def test_decode_attention_ragged_rows_equal_solo():
    """Aggregated requests of very different lengths stay independent, and
    a request with nothing cached gets 0, as the TPU kernel gives."""
    (jq, q), (jk, k), (jv, v) = attention_inputs(0, 5, 4, 2, 32, 512)
    lens = np.array([1, 100, 333, 512, 0], np.int32)
    cl = torch.from_numpy(lens)
    batched = da.decode_attention_plain(q, k, v, cl)
    for i in range(5):
        solo = da.decode_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                         cl[i:i + 1])
        np.testing.assert_allclose(batched[i].numpy(), solo[0].numpy(),
                                   atol=2e-5, rtol=2e-5)
    assert not bool(batched[4].any())
    close(batched, jda(jq, jk, jv, jnp.asarray(lens), bs=128), 2e-5)


# ---------------------------------------------------------------------------
# grouped GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("e,c,k,n", [(4, 256, 512, 384), (2, 128, 256, 128),
                                     (8, 128, 128, 256)])
def test_grouped_gemm_plain_matches_jax(bf16, e, c, k, n):
    rng = np.random.default_rng(e * 100 + n)
    jx, x = both(0.1 * rng.standard_normal((e, c, k)), bf16)
    jw, w = both(0.1 * rng.standard_normal((e, k, n)), bf16)
    gl = rng.integers(0, c + 1, e).astype(np.int32)
    got = gg.grouped_gemm_plain(x, w, torch.from_numpy(gl))
    assert got.dtype == x.dtype
    tol = 2e-2 if bf16 else 1e-5
    jgl = jnp.asarray(gl)
    close(got, jgg(jx, jw, jgl, bc=128, bn=128, bk=128), tol)
    close(got, jref.grouped_gemm_ref(jx, jw, jgl), tol)
    assert torch.equal(ops.grouped_gemm(x, w, torch.from_numpy(gl)), got)


def test_grouped_gemm_empty_and_full_groups():
    e, c, k, n = 3, 128, 128, 128
    x = torch.ones((e, c, k))
    w = torch.ones((e, k, n))
    gl = torch.tensor([0, c, 17], dtype=torch.int32)
    y = gg.grouped_gemm_plain(x, w, gl)
    assert not bool(y[0].any())                              # empty -> 0
    assert bool((y[1] == k).all())
    assert not bool(y[2, 17:].any())                         # beyond -> 0
    assert bool((y[2, :17] == k).all())
    want = jgg(jnp.ones((e, c, k)), jnp.ones((e, k, n)), jnp.asarray(gl))
    close(y, want, 0.0)


# ---------------------------------------------------------------------------
# the wrappers' checks (they raise before any build, so they run here)
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    q, k = torch.zeros(2, 4, 64), torch.zeros(2, 16, 2, 64)
    cl = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        da.decode_attention_cuda(q, k, k, cl)
    assert da.check_kernel_args(q, k, k, cl) == 2
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        da.check_kernel_args(torch.zeros(2, 4, 12), torch.zeros(2, 16, 2, 12),
                             torch.zeros(2, 16, 2, 12), cl)
    with pytest.raises(NotImplementedError, match="query heads"):
        da.check_kernel_args(torch.zeros(2, 34, 64), k[:, :, :2], k[:, :, :2],
                             cl)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        da.check_kernel_args(q.double(), k.double(), k.double(), cl)
    with pytest.raises(ValueError, match="int32"):
        da.check_kernel_args(q, k, k, cl.long())
    x, w = torch.zeros(3, 8, 16), torch.zeros(3, 16, 24)
    gl = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gg.grouped_gemm_cuda(x, w, gl)
    gg.check_kernel_args(x, w, gl)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        gg.check_kernel_args(x, torch.zeros(3, 16, 20), gl)
    with pytest.raises(ValueError, match="contiguous"):
        gg.check_kernel_args(x, w.transpose(1, 2).contiguous().transpose(
            1, 2), gl)
    with pytest.raises(TypeError, match="share one dtype"):
        gg.check_kernel_args(x, w.to(torch.bfloat16), gl)
