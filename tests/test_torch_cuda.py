"""The port's CUDA kernels and CUDA streams, on the card.

Every test here needs an NVIDIA GPU (sm_90) and skips without one.  The
file imports neither JAX nor the reference, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)  Each kernel is held to
its plain PyTorch version with the reference's kernel tolerance
(tests/test_kernels.py), ``atol=2e-6*scale``, ``rtol=2e-5``, with the scale
taken per slot and field: a slot of small values is held to its own scale,
not to the largest slot's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.amr_sedov import CONFIG as ACFG  # noqa: E402
from repro_torch.configs.amr_sedov import CONFIG_MIXED  # noqa: E402
from repro_torch.configs.base import AggregationConfig, HydroConfig  # noqa: E402
from repro_torch.configs.gravity import CONFIG_SMALL as GCFG  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AMRSedovScenario, GravityScenario, StrategyRunner, UniformSedovScenario,
)
from repro_torch.hydro.state import (  # noqa: E402
    amr_sedov_init, extract_subgrids, sedov_init,
)
from repro_torch.hydro.stepper import (  # noqa: E402
    amr_courant_dt, amr_reference_step, courant_dt,
)
from repro_torch.kernels import gravity as grav  # noqa: E402
from repro_torch.kernels import hydro_rhs as kern  # noqa: E402
from repro_torch.kernels import hydro_split as split  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.requires_cuda

KW = dict(h=0.01, gamma=1.4, ghost=3, subgrid=8)
CFG = HydroConfig(levels=1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def random_slots(seed, n, dev, s=8, g=3):
    rng = np.random.default_rng(seed)
    p = s + 2 * g
    rho = 1.0 + 0.3 * rng.random((n, 1, p, p, p))
    v = 0.2 * rng.standard_normal((n, 3, p, p, p))
    pr = 1.0 + 0.5 * rng.random((n, 1, p, p, p))
    e = pr / 0.4 + 0.5 * rho * np.sum(v * v, axis=1, keepdims=True)
    u = np.concatenate([rho, rho * v, e], axis=1).astype(np.float32)
    return torch.from_numpy(u).to(dev)


def assert_within_kernel_tol(got, want, atol_scale=2e-6):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    scale = np.abs(want).reshape(want.shape[:2] + (-1,)).max(-1)
    scale = scale.reshape(scale.shape + (1,) * (want.ndim - 2))
    bound = atol_scale * scale + 2e-5 * np.abs(want)
    excess = np.abs(got - want) - bound
    worst = np.unravel_index(np.argmax(excess), excess.shape)
    assert excess[worst] <= 0, (
        f"slot {worst[0]} field {worst[1]}: got {got[worst]}, want "
        f"{want[worst]} (slot-field scale {scale[worst[:2]]})")


def test_kernel_matches_plain(dev):
    sedov = extract_subgrids(sedov_init(CFG, device=dev).u, 8, 3)
    u = torch.cat([random_slots(70, 3, dev), sedov]).contiguous()
    before = kern.hydro_rhs_cuda.launches
    got = kern.hydro_rhs_cuda(u, **KW)
    torch.cuda.synchronize(dev)
    assert kern.hydro_rhs_cuda.launches == before + 1
    assert_within_kernel_tol(got, kern.hydro_rhs_plain(u, **KW))
    # a slot's result does not depend on its bucket
    for i in (0, 5):
        assert torch.equal(kern.hydro_rhs_cuda(u[i:i + 1], **KW),
                           got[i:i + 1])
    assert torch.equal(ops.hydro_rhs(u, **KW), got)


def test_kernel_h_slots(dev):
    u = random_slots(71, 4, dev)
    hs = torch.tensor([0.02, 0.01, 0.02, 0.01], device=dev)
    kw = dict(gamma=1.4, ghost=3, subgrid=8)
    got = kern.hydro_rhs_cuda(u, h_slots=hs, **kw)
    assert_within_kernel_tol(got, kern.hydro_rhs_plain(u, h_slots=hs, **kw))
    static = kern.hydro_rhs_cuda(u, h=0.01, **kw)
    assert torch.equal(got[1::2], static[1::2])


def test_kernel_small_subgrid(dev):
    kw = dict(h=0.02, gamma=1.4, ghost=3, subgrid=4)
    u = random_slots(72, 2, dev, s=4)
    assert_within_kernel_tol(kern.hydro_rhs_cuda(u, **kw),
                             kern.hydro_rhs_plain(u, **kw))


def test_kernel_rejects_without_falling_back(dev):
    u = random_slots(73, 2, dev)
    with pytest.raises(ValueError, match="contiguous"):
        kern.hydro_rhs_cuda(u.transpose(3, 4), **KW)
    with pytest.raises(TypeError, match="float32"):
        kern.hydro_rhs_cuda(u.double(), **KW)
    assert kern.hydro_rhs_cuda(u[:0], **KW).shape == (0, 5, 8, 8, 8)


def test_streams_bit_identical_to_fused(dev):
    u0 = sedov_init(CFG, device=dev).u
    dt = courant_dt(u0, CFG)
    outs = []
    for agg in (AggregationConfig(strategy="fused"),
                AggregationConfig(strategy="s3", max_aggregated=2),
                AggregationConfig(strategy="s2+s3", max_aggregated=2,
                                  n_executors=4)):
        runner = StrategyRunner(UniformSedovScenario(CFG), agg, device=dev)
        runner.warmup()
        outs.append(runner.rk3_step(u0, dt))
    torch.cuda.synchronize(dev)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


BUCKETS = [1, 3, 31, 32, 33, 512]


def bucket_starts(n, total=512):
    """First, middle and last bucket of n slots in a whole wave."""
    return sorted({0, (total - n) // 2, total - n})


def sedov_and_random(dev, s, seed, total=512):
    """``total`` padded sub-grids of s^3: random smooth states, then the
    Sedov IC's (the blast, floors, near-vacuum pressure)."""
    c = HydroConfig(subgrid=s, levels=1)
    sedov = extract_subgrids(sedov_init(c, device=dev).u, s, 3)
    return torch.cat([random_slots(seed, total, dev, s=s),
                      sedov])[-total:].contiguous()


@pytest.mark.parametrize("case", BUCKETS + ["odd5", "odd7", "misaligned"])
def test_cluster_kernel_buckets_plain_and_lane(dev, case):
    """A bucket of n slots (one cluster per slot) is within the kernel
    tolerance of the plain version, equals the same slots of a whole-wave
    launch and the lane kernel bit for bit: at S=8, at odd S (every other
    slot off a 16-byte boundary) and for a tensor one float past a 16-byte
    boundary."""
    s = {"odd5": 5, "odd7": 7}.get(case, 8)
    kw = dict(KW, subgrid=s)
    u = sedov_and_random(dev, s, 76, total=512 if s == 8 else 64)
    if case == "misaligned":
        buf = torch.empty(u.numel() + 1, device=dev)
        u = buf[1:].view(u.shape)
        u.copy_(sedov_and_random(dev, s, 76))
        assert u.data_ptr() % 16 == 4
    total = u.shape[0]
    whole = kern.hydro_rhs_cuda(u, **kw)
    sizes = [case] if isinstance(case, int) else [1, 3, 31, 32, 33]
    for n in sizes:
        for a in bucket_starts(n, total):
            x = u[a:a + n]
            got = kern.hydro_rhs_cuda(x, **kw)
            assert torch.equal(got, whole[a:a + n]), (n, a)
            lane = kern.hydro_rhs_lane_cuda(lane_major(x), h=KW["h"],
                                            subgrid=s, **LKW)
            assert torch.equal(slot_major(lane), got), (n, a)
    assert_within_kernel_tol(whole, kern.hydro_rhs_plain(u, **kw))
    if case == "misaligned":
        assert torch.equal(whole, kern.hydro_rhs_cuda(u.clone(), **kw))


GKW = dict(ghost=3, subgrid=8, g_const=1.0, n_iter=8)
WIDE_BUCKETS = [1, 3, 32, 33, 512]


def gravity_slots(dev, s, seed, total=512):
    """``sedov_and_random`` with every density made positive."""
    u = sedov_and_random(dev, s, seed, total)
    u[:, 0] = u[:, 0].abs() + 0.5
    return u


def test_gravity_kernel_matches_plain(dev):
    """Bit-equal to the plain version in a 512-slot launch with widths 2h, h,
    and every slot equal to its result from buckets of 1, 3, 32 and 33."""
    u = gravity_slots(dev, 8, 80)
    hs = torch.where(torch.arange(u.shape[0], device=dev) % 2 == 0,
                     torch.tensor(0.125, device=dev),
                     torch.tensor(0.0625, device=dev)).float().contiguous()
    before = grav.gravity_cuda.launches
    got = grav.gravity_cuda(u, hs, **GKW)
    torch.cuda.synchronize(dev)
    assert grav.gravity_cuda.launches == before + 1
    assert torch.equal(got, grav.gravity_plain(u, hs, **GKW))
    for n in WIDE_BUCKETS:
        for a in bucket_starts(n):
            assert torch.equal(grav.gravity_cuda(u[a:a + n], hs[a:a + n],
                                                 **GKW), got[a:a + n]), (n, a)
    assert torch.equal(ops.gravity(u, hs, **GKW), got)
    zero = grav.gravity_cuda(torch.zeros_like(u[:2]), hs[:2], **GKW)
    assert not bool(zero.any())
    with pytest.raises(ValueError, match="h_slots"):
        grav.gravity_cuda(u, hs.cpu(), **GKW)


@pytest.mark.parametrize("s,g", [(5, 3), (16, 3), (10, 3), (21, 3), (1, 1)])
def test_gravity_kernel_other_sizes_bit_equal(dev, s, g):
    """At odd and 16^3 sub-grids (1 and 8 cells per thread), at 10^3 (3
    cells on the 8-cell instance), at P = 27 (16 cells) and at P = 3 (one
    cell): bit-equal to the plain version for 0, 1 and 8 sweeps."""
    u = gravity_slots(dev, s, 81, total=64) if g == 3 else torch.from_numpy(
        np.random.default_rng(81).random((64, 5, 3, 3, 3), np.float32)
        + np.float32(0.5)).to(dev)
    hs = torch.full((64,), 0.05, device=dev)
    kw = dict(GKW, ghost=g, subgrid=s)
    for n_iter in (0, 1, 8):
        kw["n_iter"] = n_iter
        got = grav.gravity_cuda(u, hs, **kw)
        assert torch.equal(got, grav.gravity_plain(u, hs, **kw)), n_iter
    assert torch.equal(grav.gravity_cuda(u[5:6], hs[5:6], **kw), got[5:6])


def test_gravity_kernel_rejects_without_falling_back(dev):
    u = gravity_slots(dev, 8, 82, total=4)
    hs = torch.full((4,), 0.1, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        grav.gravity_cuda(u.transpose(3, 4), hs, **GKW)
    with pytest.raises(TypeError, match="float32"):
        grav.gravity_cuda(u.double(), hs, **GKW)
    big = torch.zeros((1, 5, 28, 28, 28), device=dev)
    with pytest.raises(NotImplementedError, match="registers"):
        grav.gravity_cuda(big, hs[:1], ghost=3, subgrid=22)
    # the library refuses P = 28 too: no instance holds 18 cells per thread
    out = torch.empty((1, 4, 22, 22, 22), device=dev)
    lib = grav.build()
    with torch.cuda.device(dev):
        err = lib.gravity_launch(big.data_ptr(), hs.data_ptr(),
                                 out.data_ptr(), 1, 22, 3, 1.0, 8,
                                 torch.cuda.current_stream(dev).cuda_stream)
    assert err != 0
    assert grav.gravity_cuda(u[:0], hs[:0], **GKW).shape == (0, 4, 8, 8, 8)


def by_field(r):
    """(n, 13, 2, F, P, P, P) -> (n, F, 26 P, P, P): the tolerance's scale
    per slot and field over every pair, side and cell."""
    n, p = r.shape[0], r.shape[-1]
    return r.permute(0, 3, 1, 2, 4, 5, 6).reshape(n, 5, 26 * p, p, p)


def test_split_kernels_match_plain(dev):
    sedov = extract_subgrids(sedov_init(CFG, device=dev).u, 8, 3)
    u = torch.cat([random_slots(81, 3, dev), sedov]).contiguous()
    before = (split.hydro_reconstruct_cuda.launches,
              split.hydro_flux_cuda.launches)
    recon = split.hydro_reconstruct_cuda(u)
    want_recon = split.hydro_reconstruct_plain(u)
    assert_within_kernel_tol(by_field(recon), by_field(want_recon))
    out = split.hydro_flux_cuda(want_recon, **KW)
    assert_within_kernel_tol(out, split.hydro_flux_plain(want_recon, **KW))
    pair = split.hydro_flux_cuda(recon, **KW)
    assert_within_kernel_tol(pair, kern.hydro_rhs_cuda(u, **KW),
                             atol_scale=3e-6)
    assert (split.hydro_reconstruct_cuda.launches,
            split.hydro_flux_cuda.launches) == (before[0] + 1,
                                                before[1] + 2)
    assert torch.equal(split.hydro_flux_cuda(recon[2:4], **KW), pair[2:4])
    body = ops.hydro_split_batched_body(CFG, KW["h"])
    assert torch.equal(body(u), pair)
    # every slot of a 512-slot launch equals its result from any bucket
    u = sedov_and_random(dev, 8, 83)
    whole = split.hydro_reconstruct_cuda(u)
    for n in WIDE_BUCKETS:
        for a in bucket_starts(n):
            assert torch.equal(split.hydro_reconstruct_cuda(u[a:a + n]),
                               whole[a:a + n]), (n, a)


def reconstruct_into(u, out):
    """Reconstruct launched straight through its library into ``out`` (the
    wrapper allocates its own output, so this is how an output off a
    16-byte boundary reaches the kernel)."""
    lib = split.build()
    p = u.shape[-1]
    with torch.cuda.device(u.device):
        split._ready(lib, u.device)
        err = lib.hydro_reconstruct_launch(
            u.data_ptr(), out.data_ptr(), u.shape[0], p,
            torch.cuda.current_stream(u.device).cuda_stream)
    assert err == 0, lib.hydro_split_error_string(err)


@pytest.mark.parametrize("s", [5, 8])
@pytest.mark.parametrize("off_in,off_out", [(0, 0), (1, 0), (0, 1), (3, 2)])
def test_reconstruct_odd_and_misaligned(dev, s, off_in, off_out):
    """Reconstruct at 5^3 (P = 11: every plane starts at its own offset
    within 16 bytes) and 8^3, on an input and into an output ``off_in`` and
    ``off_out`` floats past a 16-byte boundary (plain 4-byte stores take
    any float address): within the kernel tolerance of the plain version
    at every cell, equal to the aligned launch and to the slots' results
    from buckets of 1 and 33, every element written."""
    u = sedov_and_random(dev, s, 84, total=64)
    p = s + 6
    shape = (64, 13, 2, 5, p, p, p)
    buf = torch.empty(u.numel() + off_in, device=dev)
    ui = buf[off_in:].view(u.shape)
    ui.copy_(u)
    ob = torch.full((int(np.prod(shape)) + off_out,), float("nan"),
                    device=dev)
    got = ob[off_out:].view(shape)
    assert (ui.data_ptr() % 16, got.data_ptr() % 16) == (4 * off_in,
                                                         4 * off_out)
    reconstruct_into(ui, got)
    assert_within_kernel_tol(by_field(got),
                             by_field(split.hydro_reconstruct_plain(u)))
    aligned = split.hydro_reconstruct_cuda(u)
    assert torch.equal(got, aligned)
    for n in (1, 33):
        for a in bucket_starts(n, 64):
            assert torch.equal(split.hydro_reconstruct_cuda(ui[a:a + n]),
                               aligned[a:a + n]), (n, a)


def test_reconstruct_rejects_without_falling_back(dev):
    u = random_slots(85, 2, dev)
    with pytest.raises(ValueError, match="contiguous"):
        split.hydro_reconstruct_cuda(u.transpose(3, 4))
    with pytest.raises(TypeError, match="float32"):
        split.hydro_reconstruct_cuda(u.double())
    big = torch.zeros((1, 5, 63, 63, 63), device=dev)
    with pytest.raises(NotImplementedError, match="shared memory"):
        split.hydro_reconstruct_cuda(big)
    # the library refuses P = 63 too: its staged slab exceeds shared memory
    out = torch.empty((1, 13, 2, 5, 63, 63, 63), device=dev)
    with pytest.raises(AssertionError):
        reconstruct_into(big, out)
    assert split.hydro_reconstruct_cuda(u[:0]).shape == (0, 13, 2, 5, 14,
                                                         14, 14)


@pytest.mark.parametrize("n", BUCKETS)
def test_flux_kernel_buckets(dev, n):
    """A Flux bucket of n slots (one cluster per slot) equals the same slots
    of a 512-slot launch bit for bit and is within the kernel tolerance of
    the plain version."""
    recon = split.hydro_reconstruct_plain(sedov_and_random(dev, 8, 79))
    whole = split.hydro_flux_cuda(recon, **KW)
    for a in bucket_starts(n):
        got = split.hydro_flux_cuda(recon[a:a + n], **KW)
        assert torch.equal(got, whole[a:a + n]), a
    assert_within_kernel_tol(got, split.hydro_flux_plain(recon[a:a + n],
                                                         **KW))


def test_gravity_path_streams_bit_identical_to_fused(dev):
    hc = GCFG.hydro
    u0 = sedov_init(hc, device=dev).u
    dt = courant_dt(u0, hc)
    outs = []
    for agg in (AggregationConfig(strategy="fused"),
                AggregationConfig(strategy="s3", max_aggregated=2),
                AggregationConfig(strategy="s2+s3", max_aggregated=2,
                                  n_executors=4)):
        runner = StrategyRunner(GravityScenario(GCFG), agg, device=dev)
        runner.warmup()
        outs.append(runner.rk3_step(u0, dt))
        if agg.strategy != "fused":
            assert runner.launches_by_family == {"hydro_rhs": 12,
                                                 "gravity": 12}
    torch.cuda.synchronize(dev)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


LKW = dict(gamma=1.4, ghost=3)


def lane_major(u):
    return u.permute(1, 2, 3, 4, 0).contiguous()


def slot_major(x):
    return x.permute(4, 0, 1, 2, 3)


def assert_buckets_independent(u, whole, widths, s):
    """Every slot of ``whole`` equals that slot from buckets of 1 and 3,
    bit for bit."""
    n = u.shape[0]
    for size in (1, 3):
        for a in range(0, n, size):
            b = min(a + size, n)
            kw = (dict(h_slots=widths[a:b].contiguous())
                  if isinstance(widths, torch.Tensor) else dict(h=widths))
            part = kern.hydro_rhs_lane_cuda(lane_major(u[a:b]), subgrid=s,
                                            **kw, **LKW)
            assert torch.equal(part, whole[..., a:b]), (size, a)


def test_lane_kernel_matches_plain_and_slot_grid(dev):
    sedov = extract_subgrids(sedov_init(CFG, device=dev).u, 8, 3)
    u = torch.cat([random_slots(74, 3, dev), sedov]).contiguous()
    ut = lane_major(u)
    hs = torch.where(torch.arange(u.shape[0], device=dev) % 2 == 0,
                     torch.tensor(0.02, device=dev),
                     torch.tensor(0.01, device=dev)).float().contiguous()
    for widths in (0.01, hs):
        kw = (dict(h_slots=widths) if isinstance(widths, torch.Tensor)
              else dict(h=widths))
        before = kern.hydro_rhs_lane_cuda.launches
        got = kern.hydro_rhs_lane_cuda(ut, subgrid=8, **kw, **LKW)
        torch.cuda.synchronize(dev)
        assert kern.hydro_rhs_lane_cuda.launches == before + 1
        want = kern.hydro_rhs_lane_plain(ut, subgrid=8, **kw, **LKW)
        assert_within_kernel_tol(slot_major(got), slot_major(want))
        assert_within_kernel_tol(
            slot_major(got), kern.hydro_rhs_cuda(u, subgrid=8, **kw, **LKW))
        assert_buckets_independent(u, got, widths, 8)
        assert torch.equal(
            ops.hydro_rhs(u, subgrid=8, layout="slot_lane", **kw, **LKW),
            slot_major(got).contiguous())
    empty = kern.hydro_rhs_lane_cuda(ut[..., :0].contiguous(), h=0.01,
                                     subgrid=8, **LKW)
    assert empty.shape == (5, 8, 8, 8, 0)
    with pytest.raises(ValueError, match="h_slots"):
        kern.hydro_rhs_lane_cuda(ut, h_slots=hs.cpu(), subgrid=8, **LKW)
    with pytest.raises(ValueError, match="contiguous"):
        kern.hydro_rhs_lane_cuda(ut.transpose(1, 2), h=0.01, subgrid=8,
                                 **LKW)


def test_lane_kernel_at_16(dev):
    """64^3 of 16^3 sub-grids, which the slot_grid kernel takes in two
    x-slabs per slot: the two kernels agree bit for bit."""
    c16 = HydroConfig(subgrid=16, levels=1)
    sedov = extract_subgrids(sedov_init(c16, device=dev).u, 16, 3)
    u = torch.cat([random_slots(75, 2, dev, s=16), sedov]).contiguous()
    ut = lane_major(u)
    got = kern.hydro_rhs_lane_cuda(ut, h=0.01, subgrid=16, **LKW)
    assert got.shape == (5, 16, 16, 16, u.shape[0])
    want = kern.hydro_rhs_lane_plain(ut, h=0.01, subgrid=16, **LKW)
    assert_within_kernel_tol(slot_major(got), slot_major(want))
    assert_buckets_independent(u, got, 0.01, 16)
    assert torch.equal(kern.hydro_rhs_cuda(u, h=0.01, subgrid=16, **LKW),
                       slot_major(got))


@pytest.mark.parametrize("s", [8, 16])
@pytest.mark.parametrize("n", BUCKETS)
def test_lane_kernel_buckets(dev, n, s):
    """A lane bucket of n tasks (its own tile plan) equals the same tasks
    of a whole-wave launch bit for bit (512 at 8^3, 64 at 16^3, so n is
    clipped there), is within the kernel tolerance of the plain version,
    and at S=8 equals the slot_grid cluster kernel exactly."""
    total = 512 if s == 8 else 64
    n = min(n, total)
    u = sedov_and_random(dev, s, 83, total)
    whole = kern.hydro_rhs_lane_cuda(lane_major(u), h=KW["h"], subgrid=s,
                                     **LKW)
    for a in bucket_starts(n, total):
        x = u[a:a + n]
        got = kern.hydro_rhs_lane_cuda(lane_major(x), h=KW["h"], subgrid=s,
                                       **LKW)
        assert torch.equal(got, whole[..., a:a + n]), a
        if s == 8:
            assert torch.equal(slot_major(got),
                               kern.hydro_rhs_cuda(x, **KW)), a
    want = kern.hydro_rhs_lane_plain(lane_major(x), h=KW["h"], subgrid=s,
                                     **LKW)
    assert_within_kernel_tol(slot_major(got), slot_major(want))


def test_amr_path_both_layouts_bit_identical_to_reference(dev):
    """AMR CONFIG and CONFIG_MIXED (a 16^3 family) on both layouts: every
    strategy equals the per-level fused reference on the same bodies, and
    the two layouts agree within the kernel tolerance."""
    for cfg in (ACFG, CONFIG_MIXED):
        st = amr_sedov_init(cfg, device=dev)
        dt = amr_courant_dt(st.uc, st.uf, cfg)
        refs = {}
        for layout in ("slot_grid", "slot_lane"):
            body = functools.partial(ops.level_batched_body, cfg.gamma,
                                     cfg.ghost, layout=layout)
            ref = amr_reference_step(st.uc, st.uf, dt, cfg, level_body=body)
            refs[layout] = ref
            for agg in (AggregationConfig(strategy="fused"),
                        AggregationConfig(strategy="s3", max_aggregated=2),
                        AggregationConfig(strategy="s2+s3",
                                          max_aggregated=2, n_executors=4)):
                runner = StrategyRunner(AMRSedovScenario(
                    cfg, hydro_body=body), agg, device=dev)
                runner.warmup()
                out = runner.rk3_step((st.uc, st.uf), dt)
                torch.cuda.synchronize(dev)
                assert torch.equal(out[0], ref[0]), (cfg.name, layout, agg)
                assert torch.equal(out[1], ref[1]), (cfg.name, layout, agg)
        for grid, lane in zip(refs["slot_grid"], refs["slot_lane"]):
            assert_within_kernel_tol(grid[None], lane[None])


@pytest.mark.parametrize("n", [1, 3, 32, 64])
def test_slot_grid_kernel_at_16(dev, n):
    """The slot_grid kernel at 16^3 (two x-slabs per slot, a cluster of 6
    CTAs): n slots with a scalar width and per-slot widths, within the
    kernel tolerance of the plain version, equal to the lane kernel and to
    the same slots of a 64-slot launch bit for bit."""
    u = sedov_and_random(dev, 16, 84, total=64)
    assert kern.slab_plan(16).slabs == 2 and kern.ctas_per_slot(16) == 6
    hs = torch.where(torch.arange(64, device=dev) % 2 == 0,
                     torch.tensor(0.02, device=dev),
                     torch.tensor(0.01, device=dev)).float().contiguous()
    for widths in (0.01, hs):
        kw = (dict(h_slots=widths) if isinstance(widths, torch.Tensor)
              else dict(h=widths))
        whole = kern.hydro_rhs_cuda(u, subgrid=16, **kw, **LKW)
        for a in bucket_starts(n, 64):
            part = (dict(h_slots=widths[a:a + n].contiguous())
                    if isinstance(widths, torch.Tensor) else kw)
            before = kern.hydro_rhs_cuda.launches
            got = kern.hydro_rhs_cuda(u[a:a + n], subgrid=16, **part, **LKW)
            torch.cuda.synchronize(dev)
            assert kern.hydro_rhs_cuda.launches == before + 1
            assert torch.equal(got, whole[a:a + n]), a
            lane = kern.hydro_rhs_lane_cuda(lane_major(u[a:a + n]),
                                            subgrid=16, **part, **LKW)
            assert torch.equal(got, slot_major(lane)), a
        want = kern.hydro_rhs_plain(u[a:a + n], subgrid=16, **part, **LKW)
        assert_within_kernel_tol(got, want)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_slot_grid_kernel_at_15_every_offset(dev, offset):
    """15^3 (odd: every slot and every field's slab starts at another
    float offset of a 16-byte unit), in a tensor ``offset`` floats past a
    16-byte boundary: within tolerance of the plain version and equal to
    the lane kernel and to the aligned launch bit for bit."""
    u = sedov_and_random(dev, 15, 85, total=64)
    buf = torch.empty(u.numel() + 4, device=dev)
    x = buf[offset:offset + u.numel()].view(u.shape)
    x.copy_(u)
    assert x.data_ptr() % 16 == 4 * offset
    got = kern.hydro_rhs_cuda(x, h=0.01, subgrid=15, **LKW)
    assert torch.equal(got, kern.hydro_rhs_cuda(u, h=0.01, subgrid=15,
                                                **LKW))
    assert torch.equal(got, slot_major(kern.hydro_rhs_lane_cuda(
        lane_major(u), h=0.01, subgrid=15, **LKW)))
    assert_within_kernel_tol(got, kern.hydro_rhs_plain(u, h=0.01,
                                                       subgrid=15, **LKW))


def test_slot_grid_kernel_refuses_what_two_slabs_cannot_hold(dev):
    """18^3 needs more shared memory than a CTA has even in two x-slabs:
    the wrapper raises, launches nothing and takes no plain path."""
    p = 18 + 6
    u = torch.zeros((1, 5, p, p, p), device=dev)
    before = kern.hydro_rhs_cuda.launches
    with pytest.raises(NotImplementedError, match="shared memory"):
        kern.hydro_rhs_cuda(u, h=0.01, subgrid=18, **LKW)
    assert kern.hydro_rhs_cuda.launches == before


@pytest.mark.parametrize("strategy", ["s3", "s2+s3"])
def test_config_16_on_slot_grid_bit_identical_to_fused(dev, strategy):
    """The paper's strategy 1 (CONFIG_16, 64 sub-grids of 16^3) on the
    default slot_grid body: the aggregated rows equal ``fused`` bit for
    bit, and ``fused`` agrees with the lane kernel's ``fused`` within the
    kernel tolerance."""
    from repro_torch.configs.sedov import CONFIG_16

    u = sedov_init(CONFIG_16, device=dev).u
    dt = courant_dt(u, CONFIG_16)
    ref = StrategyRunner(UniformSedovScenario(CONFIG_16),
                         AggregationConfig(strategy="fused"),
                         device=dev).rk3_step(u, dt)
    h = CONFIG_16.domain / (CONFIG_16.grids_per_edge * CONFIG_16.subgrid)
    lane_body = ops.hydro_batched_body(CONFIG_16, h, layout="slot_lane")
    lane = StrategyRunner(UniformSedovScenario(CONFIG_16,
                                               batched_body=lane_body),
                          AggregationConfig(strategy="fused"),
                          device=dev).rk3_step(u, dt)
    runner = StrategyRunner(UniformSedovScenario(CONFIG_16), AggregationConfig(
        strategy=strategy, max_aggregated=32, n_executors=4), device=dev)
    runner.warmup()
    out = runner.rk3_step(u, dt)
    torch.cuda.synchronize(dev)
    assert torch.equal(out, ref)
    assert_within_kernel_tol(ref[None], lane[None])


def test_launch_timer_medians_and_ladder(dev):
    """The event timer gives positive finite seconds per launch, and a cost
    model fed from it (through the executor's warmup and a retune) derives
    a ladder that holds bucket 1, bit-equal results throughout."""
    from repro_torch.core import LaunchTimer

    timer = LaunchTimer(reps=4)
    u = sedov_and_random(dev, 8, 86, total=64)
    sample = timer(lambda: kern.hydro_rhs_cuda(u, **KW), dev, "s3", 64)
    assert np.isfinite(sample) and sample > 0
    agg = AggregationConfig(strategy="s3", max_aggregated=32, autotune=True,
                            autotune_warmup=1, cost_model=True,
                            inner_chunk="auto")
    runner = StrategyRunner(UniformSedovScenario(CFG), agg, device=dev,
                            timer=timer)
    runner.warmup()
    st = sedov_init(CFG, device=dev).u
    ref = StrategyRunner(UniformSedovScenario(CFG),
                         AggregationConfig(strategy="fused"),
                         device=dev).rk3_step(st, 1e-4)
    for _ in range(2):
        out = runner.rk3_step(st, 1e-4)
        torch.cuda.synchronize(dev)
        assert torch.equal(out, ref)
    (fam,) = runner.stats["regions"].values()
    table = fam["cost_model"]
    assert table and all(np.isfinite(t) and t > 0 for t in table.values())
    assert fam["tuned_by"] == "measured" and 1 in fam["ladder"]


def test_mixed_routes_bit_identical_to_fused(dev):
    """``mixed`` on the gravity path, each family on each route and the
    measured choice (``auto``), equals ``fused`` bit for bit."""
    st = sedov_init(GCFG.hydro, device=dev).u
    ref = StrategyRunner(GravityScenario(GCFG),
                         AggregationConfig(strategy="fused"),
                         device=dev).rk3_step(st, 1e-4)
    for routes in ({"hydro_rhs": "s3", "gravity": "fused"},
                   {"hydro_rhs": "s2", "gravity": "s3"}, None):
        agg = AggregationConfig(strategy="mixed", max_aggregated=32,
                                n_executors=4, cost_model=routes is None,
                                family_strategies=routes)
        runner = StrategyRunner(GravityScenario(GCFG), agg, device=dev)
        runner.warmup()
        out = runner.rk3_step(st, 1e-4)
        torch.cuda.synchronize(dev)
        assert torch.equal(out, ref), routes


# ---------------------------------------------------------------------------
# the serving kernels: decode attention and the grouped GEMM
# ---------------------------------------------------------------------------

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import grouped_gemm as gg  # noqa: E402

# the reference's kernel tolerances (tests/test_kernels.py)
DA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def normal(seed, shape, dev, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(x).to(dev).to(dtype)


def assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", [(16, 16, 128), (32, 8, 128),
                                      (12, 4, 64), (32, 8, 80)])
def test_decode_attention_kernel_matches_plain(dev, dtype, hq, hkv, d):
    """Ragged lengths (1, a tile edge, S and 0 among them) at the shapes of
    qwen2-moe (MHA), granite-8b (GQA 4), the reference's sweep and a head
    dimension of 80; every request equals its solo launch bit for bit."""
    s = 256
    lens = [1, 64, 65, 200, s, 0]
    b = len(lens)
    q = normal(1, (b, hq, d), dev, dtype)
    k = normal(2, (b, s, hkv, d), dev, dtype)
    v = normal(3, (b, s, hkv, d), dev, dtype)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = da.decode_attention_cuda.launches
    got = da.decode_attention_cuda(q, k, v, cl)
    torch.cuda.synchronize(dev)
    assert da.decode_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, hq, d)
    want = da.decode_attention_plain(q, k, v, cl)
    assert_close(got, want, DA_TOL[dtype])
    assert not bool(got[-1].any())            # cache_len 0 -> exactly 0
    for i in range(b):
        solo = da.decode_attention_cuda(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        cl[i:i + 1])
        assert torch.equal(solo[0], got[i]), i
    # what lies past a request's length is never read
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lens):
        k2[i, n:] = float("nan")
        v2[i, n:] = float("nan")
    assert torch.equal(da.decode_attention_cuda(q, k2, v2, cl), got)
    assert torch.equal(ops.decode_attention(q, k, v, cl), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [1, 4])
def test_decode_attention_split_at_chunk_edges(dev, dtype, g):
    """Lengths 0, 1, chunk - 1, chunk, chunk + 1 and S of the launch plan,
    with NaN stored past each length: finite, within the tolerance of the
    plain version on the NaN-free caches, each request equal to its solo
    launch, cache_len 0 exactly 0."""
    s, d, hkv = 256, 128, 2
    chunk, _ = da.launch_plan(s, d)
    lens = [0, 1, chunk - 1, chunk, chunk + 1, s]
    b = len(lens)
    q = normal(11, (b, g * hkv, d), dev, dtype)
    k = normal(12, (b, s, hkv, d), dev, dtype)
    v = normal(13, (b, s, hkv, d), dev, dtype)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = da.decode_attention_plain(q, k, v, cl)
    for i, n in enumerate(lens):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    got = da.decode_attention_cuda(q, k, v, cl)
    torch.cuda.synchronize(dev)
    assert bool(torch.isfinite(got.float()).all())
    assert_close(got, want, DA_TOL[dtype])
    assert not bool(got[0].any())
    for i in range(b):
        solo = da.decode_attention_cuda(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        cl[i:i + 1])
        assert torch.equal(solo[0], got[i]), i


def test_decode_attention_kernel_rejects_without_falling_back(dev):
    q = normal(4, (2, 4, 64), dev, torch.float32)
    k = normal(5, (2, 16, 2, 64), dev, torch.float32)
    cl = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention_cuda(q, k.transpose(1, 2).contiguous()
                                 .transpose(1, 2), k, cl)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention_cuda(q, k, k, cl.cpu())
    with pytest.raises(TypeError):
        da.decode_attention_cuda(q.half(), k.half(), k.half(), cl)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        da.decode_attention_cuda(q[..., :60].contiguous(),
                                 k[..., :60].contiguous(),
                                 k[..., :60].contiguous(), cl)


def test_empty_launches_count_nothing(dev):
    """An empty bucket (no slots, no requests) or an empty cache launches no
    kernel, so the counters stay as they were; an empty cache gives 0."""
    u = random_slots(78, 1, dev)
    q = normal(6, (2, 4, 64), dev, torch.float32)
    k = normal(7, (2, 16, 2, 64), dev, torch.float32)
    cl = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    before = (kern.hydro_rhs_cuda.launches, da.decode_attention_cuda.launches)
    assert kern.hydro_rhs_cuda(u[:0], **KW).shape == (0, 5, 8, 8, 8)
    assert da.decode_attention_cuda(q[:0], k[:0], k[:0], cl[:0]).shape == (
        0, 4, 64)
    none = da.decode_attention_cuda(q, k[:, :0].contiguous(),
                                    k[:, :0].contiguous(), cl * 0)
    assert not bool(none.any())
    assert (kern.hydro_rhs_cuda.launches,
            da.decode_attention_cuda.launches) == before
    kern.hydro_rhs_cuda(u, **KW)
    da.decode_attention_cuda(q, k, k, cl)
    assert (kern.hydro_rhs_cuda.launches,
            da.decode_attention_cuda.launches) == (before[0] + 1,
                                                   before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_grouped_gemm_kernel_matches_plain(dev, dtype):
    """Empty, single-row, tile-edge, full and ragged groups; rows past
    group_len and empty experts are exact zeros; a row's result does not
    depend on the other rows."""
    e, c, k, n = 6, 128, 1088, 136       # K past one staged chunk, N ragged
    x = normal(6, (e, c, k), dev, dtype, 0.1)
    w = normal(7, (e, k, n), dev, dtype, 0.1)
    gl = torch.tensor([0, 1, 8, 9, c, 37], dtype=torch.int32, device=dev)
    before = gg.grouped_gemm_cuda.launches
    got = gg.grouped_gemm_cuda(x, w, gl)
    torch.cuda.synchronize(dev)
    assert gg.grouped_gemm_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (e, c, n)
    assert_close(got, gg.grouped_gemm_plain(x, w, gl), GG_TOL[dtype])
    assert not bool(got[0].any())
    for ex, rows in enumerate(gl.tolist()):
        assert not bool(got[ex, rows:].any()), ex
    # other rows changed (and more of them live): row 3 of expert 5 and
    # row 0 of expert 1 come out the same, bit for bit
    x2 = normal(8, (e, c, k), dev, dtype, 0.1)
    x2[5, 3] = x[5, 3]
    x2[1, 0] = x[1, 0]
    gl2 = torch.full_like(gl, c)
    got2 = gg.grouped_gemm_cuda(x2, w, gl2)
    assert torch.equal(got2[5, 3], got[5, 3])
    assert torch.equal(got2[1, 0], got[1, 0])
    assert torch.equal(ops.grouped_gemm(x, w, gl), got)


def test_grouped_gemm_kernel_rejects_without_falling_back(dev):
    x = normal(9, (2, 8, 16), dev, torch.float32)
    w = normal(10, (2, 16, 24), dev, torch.float32)
    gl = torch.tensor([3, 8], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        gg.grouped_gemm_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                             w, gl)
    with pytest.raises(ValueError, match="group_len"):
        gg.grouped_gemm_cuda(x, w, gl.long())
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        gg.grouped_gemm_cuda(x, w[..., :20].contiguous(), gl)
    assert gg.grouped_gemm_cuda(x[:, :0].contiguous(), w, gl).shape == (
        2, 0, 24)


# ---------------------------------------------------------------------------
# staging: the slot ring on several streams, out=, s2, pinned host slabs
# ---------------------------------------------------------------------------

# ~2.5 ms at 2 GHz: longer than the host takes to fill two buckets of 8, so
# a buffer comes round again while its last launch still waits to read it
SLEEP_CYCLES = 5_000_000


def _delayed(body):
    """``body`` behind a ``torch.cuda._sleep`` on the stream it runs on, so
    a launch reads its ring slots late."""
    def slow(*args, out=None):
        torch.cuda._sleep(SLEEP_CYCLES)
        return body(*args, out=out)
    return slow


@pytest.mark.parametrize("watermark", [1, 10 ** 9])
def test_ring_reuse_on_four_streams_bit_equal_to_fused(dev, watermark):
    """64 sub-grids submitted one at a time, 3 waves in a row (each in
    another order), through the slot ring on 4 delayed executor streams at
    cap 8: a commit into a buffer that a launch still reads must wait for
    it, so every slot equals the fused kernel's result bit for bit."""
    from repro_torch.core import AggregationExecutor

    h = 1.0 / 32
    c = HydroConfig(levels=2)
    subs = extract_subgrids(sedov_init(c, device=dev).u, 8, 3)
    subs = torch.cat([random_slots(80, 32, dev), subs[:32]]).contiguous()
    want = kern.hydro_rhs_cuda(subs, **dict(KW, h=h))
    exe = AggregationExecutor(
        _delayed(ops.hydro_batched_body(c, h)), AggregationConfig(
            strategy="s2+s3", n_executors=4, max_aggregated=8,
            launch_watermark=watermark), device=dev)
    for w in range(3):
        order = torch.roll(torch.arange(64, device=dev), 11 * w)
        futs = [exe.submit(t) for t in subs[order].unbind(0)]
        exe.flush()
        got = torch.stack([f.result() for f in futs])
        assert torch.equal(got, want[order]), w
    assert exe.ring.writes == 192 and exe.ring.swaps >= 3


def test_out_equals_allocating_form_and_is_checked(dev):
    u = random_slots(81, 6, dev)
    hs = torch.full((6,), 0.01, device=dev)
    recon = split.hydro_reconstruct_cuda(u)
    cases = (
        (lambda out=None: kern.hydro_rhs_cuda(u, out=out, **KW), 5),
        (lambda out=None: grav.gravity_cuda(u, hs, ghost=3, subgrid=8,
                                            out=out), 4),
        (lambda out=None: split.hydro_flux_cuda(recon, out=out, **KW), 5),
    )
    for call, fields in cases:
        want = call()
        ring = torch.full((8, fields, 8, 8, 8), float("nan"), device=dev)
        assert call(out=ring[1:7]).data_ptr() == ring[1].data_ptr()
        assert torch.equal(ring[1:7], want)
        assert torch.isnan(ring[0]).all() and torch.isnan(ring[7]).all()
        bad = (torch.empty(6, fields, 8, 8, 16, device=dev)[..., ::2],
               torch.empty(5, fields, 8, 8, 8, device=dev),
               torch.empty(6, fields, 8, 8, 8, device=dev,
                           dtype=torch.float64),
               torch.empty(6, fields, 8, 8, 8))
        counts = (kern.hydro_rhs_cuda.launches, grav.gravity_cuda.launches,
                  split.hydro_flux_cuda.launches)
        for b in bad:
            with pytest.raises(ValueError, match="out= must be"):
                call(out=b)
        assert counts == (kern.hydro_rhs_cuda.launches,
                          grav.gravity_cuda.launches,
                          split.hydro_flux_cuda.launches)


def test_s2_bit_equal_to_fused(dev):
    """``s2`` on 4 streams, one launch per task into the output ring, on
    the uniform and the gravity scenario: equal to ``fused`` bit for bit,
    3 launches per task and step."""
    for make, cfg, fams in (
            (lambda: UniformSedovScenario(CFG), CFG, ("hydro_rhs",)),
            (lambda: GravityScenario(GCFG), GCFG.hydro,
             ("hydro_rhs", "gravity"))):
        u0 = sedov_init(cfg, device=dev).u
        dt = courant_dt(u0, cfg)
        want = StrategyRunner(make(), AggregationConfig(strategy="fused"),
                              device=dev).rk3_step(u0, dt)
        runner = StrategyRunner(make(), AggregationConfig(
            strategy="s2", n_executors=4), device=dev)
        runner.warmup()
        got = runner.rk3_step(u0, dt)
        torch.cuda.synchronize(dev)
        assert torch.equal(got, want)
        assert runner.launches_by_family == {
            f: 3 * cfg.n_subgrids for f in fams}


def test_pinned_slab_release_waits_for_its_copy(dev):
    """Host staging of CPU tensors on the card: the bucket is stacked into
    a pinned slab and copied over without blocking; with the copy held
    back on the device, the slab is not handed out again until the copy's
    event completes."""
    from repro_torch.core import AggregationExecutor

    exe = AggregationExecutor(lambda x, out=None: 2.0 * x, AggregationConfig(
        staging="host", max_aggregated=4, launch_watermark=10 ** 9),
        device=dev)
    assert exe.buffers.pinned
    xs = [torch.full((1000,), float(i)) for i in range(4)]
    torch.cuda._sleep(100_000_000)             # hold the copy back ~50 ms
    futs = [exe.submit(x) for x in xs]         # cap 4: launches here
    assert exe.buffers.in_flight == 1
    other = exe.buffers.acquire((4, 1000), torch.float32)
    assert exe.buffers.allocations == 2 and other.is_pinned()
    torch.cuda.synchronize(dev)
    exe.flush()
    slab = exe.buffers.acquire((4, 1000), torch.float32)
    assert slab is not other and exe.buffers.reuses == 1
    for i, f in enumerate(futs):
        assert torch.equal(f.result().cpu(), torch.full((1000,), 2.0 * i))


# ---------------------------------------------------------------------------
# the whole-trajectory CUDA graph, the captured AMR exchange, resume
# ---------------------------------------------------------------------------

from repro_torch.core import CaptureError  # noqa: E402


def _uniform(dev):
    u0 = sedov_init(CFG, device=dev).u
    return lambda: UniformSedovScenario(CFG), u0, courant_dt(u0, CFG)


def _amr(dev):
    st = amr_sedov_init(ACFG, device=dev)
    return (lambda: AMRSedovScenario(ACFG), (st.uc, st.uf),
            amr_courant_dt(st.uc, st.uf, ACFG))


def _split(dev):
    u0 = sedov_init(CFG, device=dev).u
    h = CFG.domain / u0.shape[-1]
    return (lambda: UniformSedovScenario(
        CFG, batched_body=ops.hydro_split_batched_body(CFG, h)), u0,
        courant_dt(u0, CFG))


TRAJECTORY_CASES = {"uniform": _uniform, "amr": _amr, "split": _split}


def _levels(state):
    return state if isinstance(state, tuple) else (state,)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_levels(a), _levels(b)))


def _loop(runner, state, dt, n):
    for _ in range(n):
        state = runner.rk3_step(state, dt)
    return state


@pytest.mark.parametrize("case", sorted(TRAJECTORY_CASES))
def test_trajectory_graph_bit_equal_to_step_loop(dev, case):
    """Under ``fused`` the trajectory is one CUDA graph: equal to the
    ``rk3_step`` loop bit for bit, counted as one launch, the caller's
    state left as it was."""
    make, u0, dt = TRAJECTORY_CASES[case](dev)
    fused = AggregationConfig(strategy="fused")
    want = _loop(StrategyRunner(make(), fused, device=dev), u0, dt, 3)
    before = tuple(u.clone() for u in _levels(u0))
    runner = StrategyRunner(make(), fused, device=dev)
    got = runner.rk3_trajectory(u0, dt, 3)
    torch.cuda.synchronize(dev)
    assert _equal(got, want)
    assert _equal(u0, before)
    assert runner.stats["kernel_launches"] == 1
    assert runner.stats["iterations"] == 9
    assert len(runner.trajectory_graphs) == 1


def test_trajectory_graph_reused_across_dts(dev):
    """One graph serves any dt of one type; an earlier result survives a
    later replay; a float dt's graph replaces the tensor dt's."""
    make, u0, dt = _uniform(dev)
    fused = AggregationConfig(strategy="fused")
    ref = StrategyRunner(make(), fused, device=dev)
    runner = StrategyRunner(make(), fused, device=dev)
    first = runner.rk3_trajectory(u0, dt, 2)
    second = runner.rk3_trajectory(u0, 0.5 * dt, 2)
    assert _equal(second, _loop(ref, u0, 0.5 * dt, 2))
    assert _equal(first, _loop(ref, u0, dt, 2))
    assert len(runner.trajectory_graphs) == 1
    third = runner.rk3_trajectory(u0, float(dt), 2)
    assert len(runner.trajectory_graphs) == 1     # another dt type
    assert _equal(third, _loop(ref, u0, float(dt), 2))
    assert _equal(first, _loop(ref, u0, dt, 2))
    assert runner.stats["kernel_launches"] == 3


@pytest.mark.parametrize("case", ["uniform", "amr"])
def test_eager_step_after_capture_equals_fresh_runner(dev, case):
    """Caches a body fills at first use are filled before the capture:
    an eager step after it equals a fresh runner's."""
    make, u0, dt = TRAJECTORY_CASES[case](dev)
    fused = AggregationConfig(strategy="fused")
    runner = StrategyRunner(make(), fused, device=dev)
    runner.rk3_trajectory(u0, dt, 1)
    fresh = StrategyRunner(make(), fused, device=dev)
    assert _equal(runner.rk3_step(u0, dt), fresh.rk3_step(u0, dt))


def _slow_level_body(cycles):
    def body(s):
        b = ops.level_batched_body(ACFG.gamma, ACFG.ghost, s)

        def slow(*args, out=None):
            torch.cuda._sleep(cycles)
            return b(*args, out=out)
        return slow
    return body


@pytest.mark.parametrize("kw", [dict(strategy="s3", max_aggregated=2),
                                dict(strategy="s2", n_executors=4)],
                         ids=["s3", "s2"])
def test_captured_amr_exchange_bit_equal_to_eager_on_delayed_streams(dev,
                                                                    kw):
    """The captured exchange's outputs are overwritten at every stage while
    launches on the executor streams read them; with those launches
    delayed, the run still equals the eager exchange's bit for bit."""
    st = amr_sedov_init(ACFG, device=dev)
    dt = amr_courant_dt(st.uc, st.uf, ACFG)
    outs = []
    for capture in (True, False):
        sc = AMRSedovScenario(ACFG, hydro_body=_slow_level_body(
            SLEEP_CYCLES))
        if not capture:
            sc.exchange = sc._exchange_eager       # the eager reference
        runner = StrategyRunner(sc, AggregationConfig(**kw), device=dev)
        outs.append(_loop(runner, (st.uc, st.uf), dt, 2))
        assert len(sc.exchange_graphs) == int(capture)
    assert _equal(outs[0], outs[1])


def test_captured_exchange_result_survives_next_call_on_delayed_stream(dev):
    """An exchange's result, read on an executor's stream delayed past the
    next exchange's replay (which nothing orders after that read), still
    holds its own exchange: a call hands out copies of the graph's
    outputs."""
    from repro_torch.core.executor import DeviceExecutor

    st = amr_sedov_init(ACFG, device=dev)
    sc = AMRSedovScenario(ACFG)
    first = sc.exchange(st.uc, st.uf)
    reader = DeviceExecutor(0, dev)
    read = reader.run(lambda s: (torch.cuda._sleep(4 * SLEEP_CYCLES),
                                 s.clone())[1], first[1])
    second = sc.exchange(2.0 * st.uc, 2.0 * st.uf)
    reader.join()
    want = sc._exchange_eager(st.uc, st.uf)
    assert len(sc.exchange_graphs) == 1
    assert torch.equal(read, want[1])
    assert torch.equal(first[0], want[0]) and torch.equal(first[1], want[1])
    assert not torch.equal(second[1], want[1])


_RESUME_CHILD = """
import os, signal, sys
from repro_torch.configs.base import AggregationConfig, HydroConfig
from repro_torch.core import StrategyRunner, UniformSedovScenario
from repro_torch.hydro.state import sedov_init
from repro_torch.hydro.stepper import courant_dt

cfg = HydroConfig(levels=1)
u0 = sedov_init(cfg, device="cuda").u
runner = StrategyRunner(UniformSedovScenario(cfg), AggregationConfig(
    strategy="s3", max_aggregated=2), device="cuda")
save = runner._checkpoint


def save_then_die(ckpt_dir, step, *args):
    save(ckpt_dir, step, *args)
    if step == 2:
        os.kill(os.getpid(), signal.SIGKILL)


runner._checkpoint = save_then_die
runner.run(u0, courant_dt(u0, cfg), 4, checkpoint_every=1,
           ckpt_dir=sys.argv[1])
"""


def test_killed_child_resumes_bit_identical(dev, tmp_path):
    """A child killed by SIGKILL after checkpoint 2 of 4 resumes in this
    process bit-identical to an uninterrupted run."""
    import os
    import subprocess
    import sys

    from repro_torch.checkpoint import latest_step

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    ckpt = str(tmp_path / "ckpt")
    child = subprocess.run([sys.executable, "-c", _RESUME_CHILD, ckpt],
                           env=env, capture_output=True, text=True,
                           timeout=300)
    assert child.returncode == -9, child.stderr[-2000:]
    assert latest_step(ckpt) == 2
    agg = AggregationConfig(strategy="s3", max_aggregated=2)
    u0 = sedov_init(CFG, device=dev).u
    want = StrategyRunner(UniformSedovScenario(CFG), agg, device=dev).run(
        u0, courant_dt(u0, CFG), 4)
    runner = StrategyRunner(UniformSedovScenario(CFG), agg, device=dev)
    assert torch.equal(runner.resume(ckpt, u0), want)
    assert runner.stats["resumed_from_step"] == 2
    assert runner.stats["recovery_steps"] == 2


def test_trajectory_capture_error_raises_not_loops(dev):
    """A body that synchronises with the host (``.item()``) cannot be
    captured: ``rk3_trajectory`` raises, and counts nothing; the card
    then captures and runs as before."""
    u0 = sedov_init(CFG, device=dev).u
    dt = courant_dt(u0, CFG)
    body = ops.hydro_batched_body(CFG, CFG.domain / u0.shape[-1])

    def syncing(u_slots, out=None):
        float(u_slots.sum().item())
        return body(u_slots, out=out)

    runner = StrategyRunner(UniformSedovScenario(CFG, batched_body=syncing),
                            AggregationConfig(strategy="fused"), device=dev)
    with pytest.raises(CaptureError, match="synchroniz"):
        runner.rk3_trajectory(u0, dt, 1)
    assert runner.stats["kernel_launches"] == 0
    assert not runner.trajectory_graphs
    make, _, _ = _uniform(dev)
    ok = StrategyRunner(make(), AggregationConfig(strategy="fused"),
                        device=dev)
    assert _equal(ok.rk3_trajectory(u0, dt, 1), ok.rk3_step(u0, dt))


# ---------------------------------------------------------------------------
# containment on the card: ring records, poison on a delayed stream, the
# launch watchdog against a real stall
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ring_reused_by_later_waves",
                                  "compaction_before_audit"])
def test_guarded_ring_launch_bisects_its_own_inputs(dev, case):
    """Per-task ring staging on 4 delayed executor streams, guarded, one
    flush at the end: by then the ring buffers of the early launches hold
    later tasks (3 waves of 64 at cap 8: a buffer comes round every other
    launch) or were rolled by a compaction (a ladder (1, 3) at cap 4).  A
    launch record that kept the live ring instead of its own copy bisects
    on other tasks' inputs: the poisoned tasks would pass and survivors
    take other tasks' results.  Exactly the poisoned tasks fail; every
    survivor equals the kernel on its own input bit for bit."""
    from repro_torch.core import AggregationExecutor, FaultInjector, FaultSpec

    h = 1.0 / 32
    c = HydroConfig(levels=2)
    subs = extract_subgrids(sedov_init(c, device=dev).u, 8, 3)
    subs = torch.cat([random_slots(82, 32, dev), subs[:32]]).contiguous()
    want = kern.hydro_rhs_cuda(subs, **dict(KW, h=h))
    if case == "ring_reused_by_later_waves":
        # region wave r holds tasks [8 r, 8 r + 8): ring poison on task 13
        # (user wave 0), payload on task 128 + 3 * 8 + 6 (user wave 2)
        cfg_kw, n_waves = dict(max_aggregated=8), 3
        specs = [FaultSpec(site="ring", task=5, wave=1),
                 FaultSpec(site="payload", task=6, wave=2 * 8 + 3)]
        want_failed = [13, 128 + 3 * 8 + 6]
    else:
        cfg_kw, n_waves = dict(max_aggregated=4, buckets=(1, 3)), 1
        specs = [FaultSpec(site="ring", task=4),
                 FaultSpec(site="payload", task=13)]
        want_failed = [4, 13]
    exe = AggregationExecutor(
        _delayed(ops.hydro_batched_body(c, h)), AggregationConfig(
            strategy="s2+s3", n_executors=4, launch_watermark=10 ** 9,
            guard="finite", **cfg_kw), device=dev,
        fault_injector=FaultInjector(specs))
    futs, refs = [], []
    for w in range(n_waves):
        order = torch.roll(torch.arange(64, device=dev), 11 * w)
        futs += [exe.submit(t) for t in subs[order].unbind(0)]
        refs.append(want[order])
    exe.flush()
    refs = torch.cat(refs)
    assert [i for i, f in enumerate(futs) if f.failed()] == want_failed
    for i, f in enumerate(futs):
        if i not in want_failed:
            assert torch.equal(f.result(), refs[i]), i
    if n_waves > 1:
        assert exe.ring.swaps >= 3 * 8
    else:
        assert exe.ring.compactions > 0


def test_poison_lands_after_the_kernel_on_a_delayed_stream(dev):
    """An injected payload poison is written on the launch's own stream,
    after the kernel: on a stream delayed ~2.5 ms the poisoned slot must
    read NaN (a poison issued on the caller's stream would land first and
    be overwritten by the kernel), the others the kernel's values; under
    the guard the same launch trips and bisects to the task."""
    from repro_torch.core import AggregationExecutor, FaultInjector, FaultSpec

    u = random_slots(83, 16, dev)
    want = kern.hydro_rhs_cuda(u, **KW)
    body = _delayed(ops.hydro_batched_body(CFG, KW["h"]))
    for guard in ("off", "finite"):
        exe = AggregationExecutor(body, AggregationConfig(
            strategy="s2+s3", n_executors=2, max_aggregated=16,
            guard=guard), device=dev,
            fault_injector=FaultInjector([FaultSpec(site="payload",
                                                    task=5)]))
        fut = exe.submit_range((u,), 0, 16)
        exe.flush()
        if guard == "off":
            got = fut.result()
            assert torch.isnan(got[5]).all()
            keep = [i for i in range(16) if i != 5]
            assert torch.equal(got[keep], want[keep])
        else:
            assert fut.failed_indices() == [5]
            assert torch.equal(fut.task_result(4), want[4])


def test_watchdog_catches_a_real_stall_and_the_executor_recovers(dev):
    """A body that sleeps ~0.2 s on its stream before the kernel under
    launch_timeout_s=0.02: the flush raises LaunchTimeoutError naming the
    family while the stall still runs (the host never blocked on the
    stream), counts one timeout, and once the sleep is over the executor
    runs a clean wave equal to the kernel."""
    import time

    from repro_torch.core import AggregationExecutor
    from repro_torch.core.faults import LaunchTimeoutError

    u = random_slots(84, 32, dev)
    want = kern.hydro_rhs_cuda(u, **KW)
    plain = ops.hydro_batched_body(CFG, KW["h"])
    stall = {"on": False}

    def body(*args, out=None):
        if stall["on"]:
            torch.cuda._sleep(400_000_000)
        return plain(*args, out=out)

    exe = AggregationExecutor(None, AggregationConfig(
        max_aggregated=32, launch_timeout_s=0.02), device=dev)
    exe.register("stalled", body)
    exe.submit_range((u,), 0, 32, kernel="stalled")
    exe.flush()
    torch.cuda.synchronize()
    stall["on"] = True
    t0 = time.perf_counter()
    with pytest.raises(LaunchTimeoutError, match="stalled"):
        exe.submit_range((u,), 0, 32, kernel="stalled")
        exe.flush()
    raised = time.perf_counter() - t0
    assert not exe.pool.executors[0].last_event.query()   # still stalled
    assert raised < 0.15
    torch.cuda.synchronize()
    assert exe.stats["regions"]["stalled[5x14x14x14]"]["faults"][
        "timeouts"] == 1
    stall["on"] = False
    fut = exe.submit_range((u,), 0, 32, kernel="stalled")
    exe.flush()
    assert torch.equal(fut.result(), want)


# ---------------------------------------------------------------------------
# warm start and tenancy on one card
# ---------------------------------------------------------------------------

_WARM_CHILD = """
import json, sys
import torch
from repro_torch.configs.base import AggregationConfig, HydroConfig
from repro_torch.core import StrategyRunner, UniformSedovScenario
from repro_torch.kernels import _build

store, data = sys.argv[1], torch.load(sys.argv[2])
runner = StrategyRunner(UniformSedovScenario(HydroConfig(levels=1)),
                        AggregationConfig(strategy="s3", max_aggregated=4,
                                          autotune=True, cost_model=True),
                        device="cuda")
runner.warmup(store=store)
u = data["u0"].cuda()
for _ in range(2):
    u = runner.rk3_step(u, data["dt"].cuda())
(fam,) = runner.stats["regions"].values()
print(json.dumps({"tuned_by": fam["tuned_by"], "ladder": fam["ladder"],
                  "measured": fam["measurement_launches"],
                  "built": {k: v["seconds"] for k, v
                            in _build.BUILD_LOG.items()},
                  "equal": bool(torch.equal(u.cpu(), data["want"]))}))
"""


def test_warm_start_round_trip_in_a_child_process(dev, tmp_path):
    """This process tunes (cost model, autotune) and saves; a fresh child
    warms up from the store: tuned by the store, no measurement launch,
    no library built, and its steps equal this process's bit for bit."""
    import json
    import os
    import subprocess
    import sys

    agg = AggregationConfig(strategy="s3", max_aggregated=4, autotune=True,
                            cost_model=True, tune_store=str(tmp_path))
    u0 = sedov_init(CFG, device=dev).u
    dt = courant_dt(u0, CFG)
    cold = StrategyRunner(UniformSedovScenario(CFG), agg, device=dev)
    cold.warmup()
    u = u0
    for _ in range(2):
        u = cold.rk3_step(u, dt)
    (fam,) = cold.stats["regions"].values()
    assert fam["tuned_by"] == "measured" and fam["measurement_launches"]
    assert os.path.isfile(tmp_path / "tunestore.json")   # the write-back
    torch.save({"u0": u0.cpu(), "dt": dt.cpu(), "want": u.cpu()},
               tmp_path / "data.pt")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "src")
    child = subprocess.run(
        [sys.executable, "-c", _WARM_CHILD, str(tmp_path),
         str(tmp_path / "data.pt")],
        env=dict(os.environ, PYTHONPATH=os.path.abspath(src)),
        capture_output=True, text=True, timeout=300)
    assert child.returncode == 0, child.stderr[-2000:]
    got = json.loads(child.stdout.strip().splitlines()[-1])
    assert got["tuned_by"] == "store" and got["measured"] == 0
    assert got["ladder"] == fam["ladder"]
    assert got["built"] and all(s is None for s in got["built"].values())
    assert got["equal"]


def _tenant_batcher(dev, n, scenario, state, dt, cap=32):
    from repro_torch.core import ShardedAggregationExecutor, TenantBatcher

    tb = TenantBatcher(ShardedAggregationExecutor(config=AggregationConfig(
        strategy="s4", max_aggregated=cap), name="tenancy", device=dev))
    for tid in range(n):
        tb.add(tid, scenario(), state, dt)
    return tb


def test_eight_staged_tenants_bit_equal_to_solo(dev):
    """Eight tenants of the main path's small config, two steps through
    the captured extract and assemble phases: each equals its solo s3
    run bit for bit, 3 merged waves per step, and no eager fallback."""
    u0 = sedov_init(CFG, device=dev).u
    dt = courant_dt(u0, CFG)
    solo = StrategyRunner(UniformSedovScenario(CFG), AggregationConfig(
        strategy="s3", max_aggregated=32), device=dev)
    want = solo.rk3_step(solo.rk3_step(u0, dt), dt)
    tb = _tenant_batcher(dev, 8, lambda: UniformSedovScenario(CFG), u0, dt)
    tb.rk3_step_all()
    out = tb.rk3_step_all()
    for tid in range(8):
        assert torch.equal(out[tid], want), tid
    assert tb.stats["waves"] == 6 and tb.stats["eager_fallbacks"] == 0
    assert len(tb._stage_cache) == 1 and not tb._eager
    # 64 tasks per wave under cap 32: two launches of 32
    assert tb.executor.stats["aggregated_hist"] == {32: 12}


class _HostSyncScenario(UniformSedovScenario):
    """The main path's scenario with a population that reads a value on
    the host (``.item()``), which no CUDA graph can capture."""

    def populations(self, state):
        assert state.sum().item() > 0
        return super().populations(state)


def test_host_sync_population_falls_to_eager_and_is_counted(dev):
    u0 = sedov_init(CFG, device=dev).u
    dt = courant_dt(u0, CFG)
    want = StrategyRunner(UniformSedovScenario(CFG), AggregationConfig(
        strategy="s3", max_aggregated=32), device=dev).rk3_step(u0, dt)
    tb = _tenant_batcher(dev, 2, lambda: _HostSyncScenario(CFG), u0, dt)
    out = tb.rk3_step_all()
    assert tb._eager and tb.stats["eager_fallbacks"] == 1
    assert tb.stats["waves"] == 3
    for tid in range(2):
        assert torch.equal(out[tid], want)
