"""The port's CUDA kernel and CUDA streams, on the card.

Every test here needs an NVIDIA GPU (sm_90) and skips without one.  The
file imports neither JAX nor the reference, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)  The kernel is held to
its plain PyTorch version with the reference's kernel tolerance
(tests/test_kernels.py), ``atol=2e-6*scale``, ``rtol=2e-5``, with the scale
taken per slot and field: a slot of small values is held to its own scale,
not to the largest slot's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import AggregationConfig, HydroConfig  # noqa: E402
from repro_torch.core import StrategyRunner, UniformSedovScenario  # noqa: E402
from repro_torch.hydro.state import extract_subgrids, sedov_init  # noqa: E402
from repro_torch.hydro.stepper import courant_dt  # noqa: E402
from repro_torch.kernels import hydro_rhs as kern  # noqa: E402
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


def assert_within_kernel_tol(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    scale = np.abs(want).reshape(want.shape[:2] + (-1,)).max(-1)
    bound = 2e-6 * scale[:, :, None, None, None] + 2e-5 * np.abs(want)
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
