"""The port's staging layer on the CPU — ``SlotRing``, ``BufferPool``, the
aggregation executor's ring and host staging, ``hydro_rhs_prefix`` and
the kernels' ``out=`` — against the JAX reference where it has the same
function.

The same inputs, made with numpy from a seed, go through ``repro`` (on the
CPU) and ``repro_torch``.  Ring contents and launch histograms must be
equal; hydro results agree within the reference's kernel tolerance
(tests/test_kernels.py), rtol 2e-5 and atol 2e-6 of the largest value.
The stream ordering of a ring reused on the card is tested on the card
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.configs.base import HydroConfig as JHydroConfig  # noqa: E402
from repro.core.aggregation import (  # noqa: E402
    AggregationExecutor as JAggregationExecutor,
)
from repro.core.buffers import SlotRing as JSlotRing  # noqa: E402
from repro.core.scenario import xla_task_body  # noqa: E402
from repro.kernels.hydro_rhs import hydro_rhs_pallas_prefix  # noqa: E402

from repro_torch.configs.base import (  # noqa: E402
    AggregationConfig, GravityHydroConfig, HydroConfig,
)
from repro_torch.core import (  # noqa: E402
    AggregationExecutor, BufferPool, SlotRing, SlotView,
)
from repro_torch.hydro.state import extract_subgrids, sedov_init  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.hydro_rhs import (  # noqa: E402
    hydro_rhs_plain, hydro_rhs_prefix,
)

CFG = HydroConfig(levels=1)          # 8 sub-grids of 8^3
JCFG = JHydroConfig(levels=1)
H = CFG.domain / (CFG.grids_per_edge * CFG.subgrid)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _affine(x, out=None):
    res = 2.0 * x + 1.0
    return res if out is None else out.copy_(res)


def _j_affine():
    return jax.vmap(lambda x: 2.0 * x + 1.0)


def assert_kernel_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-6 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def sedov_subs():
    """The Sedov IC's 8 padded sub-grids, float32 numpy."""
    u = sedov_init(CFG, device="cpu").u
    return extract_subgrids(u, CFG.subgrid, CFG.ghost).numpy()


# ---------------------------------------------------------------------------
# SlotRing against the reference's
# ---------------------------------------------------------------------------

SPECS = (((3,), np.float32), ((2, 2), np.float32), ((2,), np.int32))


def _ring_ops(seed, cap, n_ops=40):
    """A seeded sequence of ring operations, each legal where it is
    applied: write, commit, compact, swap, poison."""
    rng = np.random.default_rng(seed)
    fill, ops_ = 0, []
    for _ in range(n_ops):
        choice = rng.choice(["write", "write", "write", "commit", "compact",
                             "swap", "poison"])
        if choice == "write" and fill < cap:
            ops_.append(("write", [
                (rng.standard_normal(shape) * 10).astype(dt)
                for shape, dt in SPECS]))
            fill += 1
        elif choice == "compact" and fill:
            start = int(rng.integers(0, fill + 1))
            ops_.append(("compact", start))
            fill -= start
        elif choice == "swap":
            ops_.append(("swap",))
            fill = 0
        elif choice == "poison" and fill:
            ops_.append(("poison", int(rng.integers(0, fill)),
                         str(rng.choice(["nan", "inf"]))))
        elif choice == "commit":
            ops_.append(("commit",))
    return ops_


@pytest.mark.parametrize("seed,cap", [(0, 4), (1, 4), (2, 6), (3, 3)])
def test_slot_ring_matches_reference(seed, cap):
    """Write, commit, compact, swap and poison leave the same buffer
    contents and counters as the reference's ring, after every
    operation."""
    ex = [np.zeros(shape, dt) for shape, dt in SPECS]
    ring = SlotRing(cap, [torch.from_numpy(a) for a in ex], device="cpu")
    jring = JSlotRing(cap, [jnp.asarray(a) for a in ex])
    for op in _ring_ops(seed, cap):
        if op[0] == "write":
            assert ring.write([torch.from_numpy(a) for a in op[1]]) == \
                jring.write([jnp.asarray(a) for a in op[1]])
        elif op[0] == "poison":
            ring.poison(op[1], op[2])
            jring.poison(op[1], op[2])
        elif op[0] == "compact":
            ring.compact(op[1])
            jring.compact(op[1])
        else:
            getattr(ring, op[0])()
            getattr(jring, op[0])()
        for got, want in zip(ring.buffers(), jring.buffers()):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for name in ("fill", "writes", "commits", "compactions", "swaps"):
            assert getattr(ring, name) == getattr(jring, name), (op, name)


def test_slot_ring_commit_is_one_block_copy_and_double_buffered():
    ring = SlotRing(4, [torch.zeros(3)], device="cpu")
    for i in range(3):
        assert ring.write([torch.full((3,), float(i))]) == i
    assert ring.commits == 0              # deferred until commit
    a = ring.buffers()[0]
    assert ring.commits == 1 and ring.fill == 3
    assert torch.equal(a[:3], torch.arange(3.0)[:, None].expand(3, 3))
    ring.swap()
    assert ring.buffers()[0] is not a and ring.fill == 0
    ring.swap()
    assert ring.buffers()[0] is a
    with pytest.raises(ValueError, match="not claimed"):
        ring.poison(0)
    for i in range(4):
        ring.write([torch.zeros(3)])
    with pytest.raises(RuntimeError, match="ring full"):
        ring.write([torch.zeros(3)])


class _FakeEvent:
    """Stands in for a CUDA event: completes when told to."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_buffer_pool_recycles_and_waits_for_the_copy():
    pool = BufferPool()
    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    slab = pool.stage(parts)
    assert torch.equal(slab, torch.stack(parts)) and pool.allocations == 1
    ev = _FakeEvent()
    pool.release(slab, ev)
    assert pool.in_flight == 1
    other = pool.acquire((4, 2, 3), torch.float32)
    assert other is not slab and pool.allocations == 2   # copy not done
    ev.done = True
    assert pool.acquire((4, 2, 3), torch.float32) is slab
    assert pool.reuses == 1 and pool.in_flight == 0
    pool.release(other)
    assert pool.acquire((4, 2, 3), torch.float32) is other
    assert pool.acquire((4, 2, 3), torch.float64).dtype == torch.float64


# ---------------------------------------------------------------------------
# the executor's ring and host staging against the reference's executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("staging", ["device", "host"])
@pytest.mark.parametrize("cap,buckets,n_tasks", [
    (4, (), 9), (8, (), 29), (16, (), 64), (5, (1, 2, 5), 23),
    (1, (), 3)])
def test_per_task_launch_histogram_matches_reference(staging, cap, buckets,
                                                     n_tasks):
    """Per-task submissions, watermark out of reach: the same bucket
    histogram as the reference's executor, and every task's result."""
    kw = dict(strategy="s3", max_aggregated=cap, buckets=buckets,
              launch_watermark=10 ** 9, staging=staging)
    exe = AggregationExecutor(_affine, AggregationConfig(**kw), device=CPU)
    jexe = JAggregationExecutor(_j_affine(), JAggregationConfig(**kw))
    rng = np.random.default_rng(cap + n_tasks)
    xs = rng.standard_normal((n_tasks, 3)).astype(np.float32)
    futs = [exe.submit(torch.from_numpy(x)) for x in xs]
    for x in xs:
        jexe.submit(jnp.asarray(x))
    exe.flush()
    jexe.flush()
    assert exe.stats["aggregated_hist"] == jexe.stats["aggregated_hist"]
    assert exe.stats["launches"] == jexe.stats["launches"]
    for x, f in zip(xs, futs):
        np.testing.assert_array_equal(f.result().numpy(), 2.0 * x + 1.0)
    if staging == "device":
        assert exe.ring.writes == n_tasks
        assert exe.ring.swaps == jexe.ring.swaps
    else:
        assert exe.ring is None


def test_ring_compaction_under_watermark_remainders():
    """Partial watermark launches leave a mid-ring remainder; when the ring
    fills, the live tail slides to the front without corrupting queued
    tasks."""
    cfg = AggregationConfig(strategy="s3", max_aggregated=4, buckets=(1, 2),
                            launch_watermark=3)
    exe = AggregationExecutor(_affine, cfg, device=CPU)
    futs = [exe.submit(torch.full((2,), float(i))) for i in range(9)]
    exe.flush()
    for i, f in enumerate(futs):
        assert torch.equal(f.result(), torch.full((2,), 2.0 * i + 1.0))
    assert exe.ring.compactions >= 1


@pytest.mark.parametrize("staging", ["device", "host"])
def test_hydro_ring_and_host_staging_match_reference(sedov_subs, staging):
    """The Sedov IC's sub-grids submitted one by one, cap 4: the port's
    hydro body (plain on the CPU) through its ring or host staging against
    the reference's XLA body through its own, within the kernel tolerance;
    the launches are the same buckets."""
    kw = dict(strategy="s3", max_aggregated=4, launch_watermark=10 ** 9,
              staging=staging)
    exe = AggregationExecutor(ops.hydro_batched_body(CFG, H),
                              AggregationConfig(**kw), device=CPU)
    jexe = JAggregationExecutor(jax.vmap(xla_task_body(JCFG, H)),
                                JAggregationConfig(**kw))
    futs = [exe.submit(torch.from_numpy(s)) for s in sedov_subs]
    jfuts = [jexe.submit(jnp.asarray(s)) for s in sedov_subs]
    exe.flush()
    jexe.flush()
    assert exe.stats["aggregated_hist"] == jexe.stats["aggregated_hist"] \
        == {4: 2}
    got = np.stack([f.result().numpy() for f in futs])
    want = np.stack([np.asarray(f.result()) for f in jfuts])
    assert_kernel_close(got, want)


def test_mode_switch_flushes_pending():
    """Ring and ref entries never share a bucket: a switch of mode launches
    what is queued first."""
    parent = torch.arange(12.0).reshape(3, 4)
    cfg = AggregationConfig(strategy="s3", max_aggregated=8,
                            launch_watermark=10 ** 9)
    exe = AggregationExecutor(_affine, cfg, device=CPU)
    f_ring = exe.submit(torch.full((4,), 7.0))
    assert not f_ring.ready()
    f_ref = exe.submit(SlotView(parent, 1))
    assert f_ring.ready()                 # flushed by the mode switch
    assert not f_ref.ready()
    f_ring2 = exe.submit(torch.full((4,), 3.0))
    assert f_ref.ready()                  # and back
    exe.flush()
    assert torch.equal(f_ring.result(), torch.full((4,), 15.0))
    assert torch.equal(f_ref.result(), 2.0 * parent[1] + 1.0)
    assert torch.equal(f_ring2.result(), torch.full((4,), 7.0))
    assert exe.stats["aggregated_hist"] == {1: 3}


def test_submit_range_raises_under_host_staging():
    exe = AggregationExecutor(_affine, AggregationConfig(staging="host"),
                              device=CPU)
    parent = torch.ones(4, 2)
    with pytest.raises(ValueError, match="requires device staging"):
        exe.submit_range((parent,), 0, 4)
    f = exe.submit_indexed((parent,), 2)       # per task is the host path
    exe.flush()
    assert torch.equal(f.result(), torch.full((2,), 3.0))


def test_warmup_makes_the_ring_and_counts_nothing():
    cfg = AggregationConfig(strategy="s3", max_aggregated=4)
    exe = AggregationExecutor(_affine, cfg, device=CPU)
    exe.warmup((((6, 3), torch.float32),))
    assert exe.ring is not None and exe.ring.capacity == 4
    assert exe.stats["launches"] == 0 and exe.ring.writes == 0
    host = AggregationExecutor(_affine, AggregationConfig(staging="host"),
                               device=CPU)
    host.warmup((((6, 3), torch.float32),))
    assert host.ring is None and host.stats["launches"] == 0


def test_task_on_another_device_is_refused():
    exe = AggregationExecutor(_affine, device=CPU)
    with pytest.raises(ValueError, match="stages tensors on cpu"):
        exe.submit(torch.ones(3, device="meta"))


# ---------------------------------------------------------------------------
# hydro_rhs_prefix and out=
# ---------------------------------------------------------------------------

def test_hydro_rhs_prefix_matches_reference_and_plain(sedov_subs):
    """The prefix ``[2, 6)`` of a ring of the IC's sub-grids: equal to the
    plain version on the same slots, and within the kernel tolerance of
    the reference's ``hydro_rhs_pallas_prefix`` (interpret mode)."""
    kw = dict(h=H, gamma=CFG.gamma, ghost=CFG.ghost, subgrid=CFG.subgrid)
    ring = torch.from_numpy(sedov_subs)
    got = hydro_rhs_prefix(ring, 2, 4, **kw)
    assert torch.equal(got, hydro_rhs_plain(ring[2:6], **kw))
    out = torch.full((6, 5, 8, 8, 8), float("nan"))
    assert hydro_rhs_prefix(ring, 2, 4, out=out[1:5], **kw).data_ptr() \
        == out[1:5].data_ptr()
    assert torch.equal(out[1:5], got) and torch.isnan(out[0]).all()
    want = hydro_rhs_pallas_prefix(jnp.asarray(sedov_subs), 2, 4,
                                   interpret=True, **kw)
    assert_kernel_close(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="out of bounds"):
        hydro_rhs_prefix(ring, 6, 4, **kw)


@pytest.mark.parametrize("layout", ["slot_grid", "slot_lane"])
def test_bodies_write_into_out(sedov_subs, layout):
    """Each family body writes its result into ``out`` (a ring slice) equal
    to its allocating form; meta tensors give the output's shape."""
    u = torch.from_numpy(sedov_subs[:3].copy())
    hs = torch.full((3,), H)
    bodies = [
        (ops.hydro_batched_body(CFG, H, layout=layout), (u,), 5),
        (ops.level_batched_body(CFG.gamma, CFG.ghost, CFG.subgrid,
                                layout=layout), (u, hs), 5),
        (ops.gravity_batched_body(GravityHydroConfig(hydro=CFG)), (u, hs),
         4),
    ]
    if layout == "slot_grid":
        bodies.append((ops.hydro_split_batched_body(CFG, H), (u,), 5))
    for body, args, fields in bodies:
        want = body(*args)
        ring = torch.full((5, fields, 8, 8, 8), float("nan"))
        body(*args, out=ring[1:4])
        assert torch.equal(ring[1:4], want)
        assert torch.isnan(ring[0]).all() and torch.isnan(ring[4]).all()
        meta = body(*(torch.empty(a.shape, device="meta") for a in args))
        assert meta.shape == want.shape and meta.device.type == "meta"


def test_output_check_rejects_a_wrong_out():
    like = torch.zeros(2, 5, 14, 14, 14)
    shape = (2, 5, 8, 8, 8)
    ok = torch.empty(4, 5, 8, 8, 8)[1:3]
    assert _build.output(ok, shape, like, "k") is ok
    assert _build.output(None, shape, like, "k").shape == shape
    for bad in (torch.empty(2, 5, 8, 8, 9), torch.empty(shape,
                                                        dtype=torch.float64),
                torch.empty(2, 5, 8, 8, 16)[..., ::2]):
        with pytest.raises(ValueError, match="out= must be"):
            _build.output(bad, shape, like, "k")
