"""The split-KV decode attention's arithmetic, replayed on the CPU.

``csrc/decode_attention.cu`` cuts each request's cache into chunks of
``launch_plan(S, D)`` positions, runs an online softmax over each chunk in
tiles of ``TILE`` positions, and merges the chunks in chunk order.  The
replay below does the same in plain PyTorch (fp32), and is held to the
port's plain version and to the reference's Pallas kernel (interpret mode,
as tests/test_kernels.py runs it) at the reference's fp32 tolerance, 2e-5,
at the lengths where the partition has its edges: 0, 1, chunk - 1, chunk,
chunk + 1 and S.  The kernel itself is held to the plain version on the
card by tests/test_torch_cuda.py.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jda  # noqa: E402

from repro_torch.kernels import decode_attention as da  # noqa: E402

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def online_softmax(q, k, v, lo, hi, scale):
    """(m, l, acc) of one chunk, positions [lo, hi), tile by tile as the
    chunk kernel runs it: q (G, D), k/v (S, D) fp32."""
    g = q.shape[0]
    m = torch.full((g,), da.NEG_INF)
    lsum = torch.zeros(g)
    acc = torch.zeros(g, q.shape[1])
    for t0 in range(lo, hi, da.TILE):
        t1 = min(t0 + da.TILE, hi)
        s = (q @ k[t0:t1].T) * scale
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[:, None])
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + p @ v[t0:t1]
        m = m_new
    return m, lsum, acc


def split_replay(q, k_cache, v_cache, cache_len):
    """The kernel pair's partition and combine in plain PyTorch: (B, Hq, D)
    x (B, S, Hkv, D) caches -> (B, Hq, D) fp32."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    chunk, _ = da.launch_plan(s, d)
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(b, hkv, g, d)
    for bi in range(b):
        n = min(max(int(cache_len[bi]), 0), s)
        live = -(-n // chunk)
        for h in range(hkv):
            if live == 0:
                continue                            # nothing cached: 0
            qg = q[bi, h * g:(h + 1) * g].float()
            kk, vv = k_cache[bi, :, h].float(), v_cache[bi, :, h].float()
            parts = [online_softmax(qg, kk, vv, c * chunk,
                                    min((c + 1) * chunk, n), scale)
                     for c in range(live)]
            m = parts[0][0]
            for pm, _, _ in parts[1:]:
                m = torch.maximum(m, pm)
            den = torch.zeros(g)
            acc = torch.zeros(g, d)
            for pm, pl, pa in parts:                 # in chunk order
                w = torch.exp(pm - m)
                den = den + pl * w
                acc = acc + pa * w[:, None]
            out[bi, h] = acc / torch.clamp(den, min=1e-30)[:, None]
    return out.reshape(b, hq, d)


def inputs(seed, b, hq, hkv, d, s):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


@pytest.mark.parametrize("g", [1, 4])
def test_split_replay_matches_plain_and_jax(g):
    s, d, hkv = 256, 128, 2
    chunk, n_chunks = da.launch_plan(s, d)
    assert (chunk, n_chunks) == (64, 4)
    lens = np.array([0, 1, chunk - 1, chunk, chunk + 1, s], np.int32)
    q, k, v = inputs(g, len(lens), g * hkv, hkv, d, s)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    cl = torch.from_numpy(lens)
    got = split_replay(tq, tk, tv, cl)
    np.testing.assert_allclose(
        got.numpy(), da.decode_attention_plain(tq, tk, tv, cl).numpy(),
        atol=TOL, rtol=TOL)
    want = jda(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               jnp.asarray(lens), bs=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert not bool(got[0].any())                  # cache_len 0 -> 0
    # each request alone: the same partition, the same bits
    for i in range(len(lens)):
        solo = split_replay(tq[i:i + 1], tk[i:i + 1], tv[i:i + 1],
                            cl[i:i + 1])
        assert torch.equal(solo[0], got[i]), i


@pytest.mark.parametrize("d", [8, 64, 80, 128, 256])
def test_launch_plan_depends_on_cache_and_head_dim_only(d):
    """Chunks are whole tiles, at most MAX_CHUNKS of them cover S exactly,
    and the plan takes (S, D) alone: no batch size, no lengths."""
    assert list(da.launch_plan.__code__.co_varnames[
        :da.launch_plan.__code__.co_argcount]) == ["s", "d"]
    for s in (1, 31, 32, 33, 256, 1024, 4096, 4097, 65_536, 131_072):
        chunk, n = da.launch_plan(s, d)
        assert (chunk, n) == da.launch_plan(s, d)
        assert chunk % da.TILE == 0 and chunk >= da.TILE
        assert 1 <= n <= da.MAX_CHUNKS
        assert (n - 1) * chunk < s <= n * chunk
    # at S 1,024 the qwen2-moe head (D 128) runs 16 chunks of 64 positions
    assert da.launch_plan(1024, 128) == (64, 16)
