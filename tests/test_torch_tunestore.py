"""The port's warm start (DESIGN.md §13) against the JAX reference, on the
CPU: the tune store, the roofline prior and their wiring through the
aggregation executor and ``StrategyRunner``.

One counterpart of each test of ``tests/test_tunestore.py``, then the
port held to the reference: with the same submissions and the same known
launch times (the port through an injected timer, the reference's timed
samples overwritten with them), the persisted entry equals the reference
executor's field for field; with the same per-task flop count (the
reference's ``RooflinePrior._xla_flops`` patched to return it), the
seeded prior tables equal the reference's to 1e-12 and the ladders are
equal; and a store written by either package is stale to the other (its
code salt).  No test is decided by a clock.
"""
import json
import os
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import tunestore as jtunestore  # noqa: E402

from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    AggregationConfig, HydroConfig, validate_ladder,
)
from repro_torch.core import (  # noqa: E402
    AggregationExecutor, BucketCostModel, RooflinePrior, StrategyRunner,
    TuneStore, TuneStoreWarning, UniformSedovScenario, derive_ladder,
    greedy_decomposition,
)
from repro_torch.core.aggregation import _backend_key  # noqa: E402
from repro_torch.core.tunestore import (  # noqa: E402
    DEVICE_PEAKS, SCHEMA_VERSION, code_salt, device_peaks, entry_key,
)
from repro_torch.core.tunestore.prior import FALLBACK_FLOPS_PER_ELEM  # noqa: E402
from repro_torch.hydro.state import sedov_init  # noqa: E402
from repro_torch.hydro.stepper import courant_dt  # noqa: E402
from repro_torch.kernels import counts, ops  # noqa: E402

CPU = torch.device("cpu")
WM = 10 ** 9
SMALL = HydroConfig(levels=1, subgrid=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def affine(x, out=None):
    r = 2.0 * x + 1.0
    return r if out is None else out.copy_(r)


def jaffine(x):
    return 2.0 * x + 1.0


TIMES = {"s3": lambda b: 1e-3 * (1.0 + 0.02 * b),
         "s2": lambda w: 1e-3 * (1.0 + 0.5 * w),
         "fused": lambda n: 1e-3 * (2.0 + 0.05 * n),
         "chunk": lambda c: 1e-3 * (1.0 + c)}


def fake_timer(table=TIMES):
    """Runs the launch and reports ``table[path](size)`` seconds."""
    def timer(fn, device, path, size):
        fn()
        return table[path](size)
    return timer


def _entry(ladder=(1, 16)):
    return {"cost_model": {"s3": {"1": 1e-4, "16": 2e-4}},
            "ladder": list(ladder), "inner_chunk": 0,
            "queue_hist": {"16": 3}, "warmup_wave": 16,
            "tuned_by": "measured"}


def _kw(root, **kw):
    base = dict(strategy="s3", max_aggregated=16, launch_watermark=WM,
                autotune=True, autotune_warmup=1, cost_model=True,
                cost_samples=1, tune_store=None if root is None
                else str(root))
    base.update(kw)
    return base


def _cfg(root, **kw):
    return AggregationConfig(**_kw(root, **kw))


def _exe(cfg, body=affine):
    return AggregationExecutor(body, cfg, device=CPU, timer=fake_timer())


SPECS = (((16, 2), torch.float32),)
PARENT = torch.arange(32.0).reshape(16, 2)


def _run_wave(exe, parent=PARENT, n=16):
    fut = exe.submit_range((parent,), 0, n)
    exe.flush()
    return fut.result()


def _region(exe):
    (region,) = exe.regions.values()
    return region


# ---------------------------------------------------------------------------
# store mechanics
# ---------------------------------------------------------------------------

def test_store_roundtrip(tmp_path):
    store = TuneStore(str(tmp_path))
    store.put(("cpu", "cpu0"), "fam[16x2,f32]", _entry())
    store.save()
    again = TuneStore(str(tmp_path))
    assert len(again) == 1
    assert again.get(("cpu", "cpu0"), "fam[16x2,f32]") == _entry()
    assert again.get(("cuda", "H100"), "fam[16x2,f32]") is None


def test_open_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_STORE", raising=False)
    assert TuneStore.open(None) is None
    store = TuneStore.open(str(tmp_path))
    assert isinstance(store, TuneStore)
    assert TuneStore.open(store) is store
    monkeypatch.setenv("REPRO_TUNE_STORE", str(tmp_path))
    via_env = TuneStore.open(None)
    assert via_env is not None and via_env.root == store.root


def test_save_merges_concurrent_entries(tmp_path):
    a, b = TuneStore(str(tmp_path)), TuneStore(str(tmp_path))
    a.put(("cpu", "cpu0"), "fam_a[8x2,f32]", _entry())
    a.save()
    b.put(("cpu", "cpu0"), "fam_b[8x3,f32]", _entry((1, 8)))
    b.save()
    merged = TuneStore(str(tmp_path)).entries()
    assert set(merged) == {entry_key(("cpu", "cpu0"), "fam_a[8x2,f32]"),
                           entry_key(("cpu", "cpu0"), "fam_b[8x3,f32]")}


def _assert_falls_back_empty(root, match=None):
    with pytest.warns(TuneStoreWarning, match=match):
        assert len(TuneStore(root)) == 0


def test_corrupt_file_warns_and_falls_back(tmp_path):
    with open(os.path.join(str(tmp_path), "tunestore.json"), "w") as f:
        f.write("{not json at all")
    _assert_falls_back_empty(str(tmp_path), "unreadable")


def test_truncated_file_warns_and_falls_back(tmp_path):
    store = TuneStore(str(tmp_path))
    store.put(("cpu", "cpu0"), "fam[16x2,f32]", _entry())
    store.save()
    with open(store.path) as f:
        blob = f.read()
    with open(store.path, "w") as f:
        f.write(blob[:len(blob) // 2])
    _assert_falls_back_empty(str(tmp_path))


def test_hash_tamper_warns_and_falls_back(tmp_path):
    store = TuneStore(str(tmp_path))
    store.put(("cpu", "cpu0"), "fam[16x2,f32]", _entry())
    store.save()
    with open(store.path) as f:
        payload = json.load(f)
    key = entry_key(("cpu", "cpu0"), "fam[16x2,f32]")
    payload["entries"][key]["ladder"] = [1, 999]
    with open(store.path, "w") as f:
        json.dump(payload, f)
    _assert_falls_back_empty(str(tmp_path), "content hash")


@pytest.mark.parametrize("field,value", [
    ("schema", SCHEMA_VERSION + 1),
    ("salt", "0000000000000000"),
])
def test_stale_schema_or_salt_ignored(tmp_path, field, value):
    store = TuneStore(str(tmp_path))
    store.put(("cpu", "cpu0"), "fam[16x2,f32]", _entry())
    store.save()
    with open(store.path) as f:
        payload = json.load(f)
    payload[field] = value
    with open(store.path, "w") as f:
        json.dump(payload, f)
    _assert_falls_back_empty(str(tmp_path), field)


def test_non_object_and_malformed_tables_warn(tmp_path):
    """The two fail-closed cases the reference's tests leave out: a JSON
    list at the top level, and an entry table holding a non-object."""
    path = os.path.join(str(tmp_path), "tunestore.json")
    with open(path, "w") as f:
        json.dump([1, 2], f)
    _assert_falls_back_empty(str(tmp_path), "non-object")
    with open(path, "w") as f:
        json.dump({"schema": SCHEMA_VERSION, "salt": code_salt(),
                   "entries": {"k": 3}, "hash": ""}, f)
    _assert_falls_back_empty(str(tmp_path), "malformed")


def test_save_repairs_corrupt_file(tmp_path):
    with open(os.path.join(str(tmp_path), "tunestore.json"), "w") as f:
        f.write("garbage")
    store = TuneStore(str(tmp_path))
    with pytest.warns(TuneStoreWarning):
        store.put(("cpu", "cpu0"), "fam[16x2,f32]", _entry())
    store.save()
    assert len(TuneStore(str(tmp_path))) == 1


def test_unchanged_save_writes_nothing(tmp_path):
    store = TuneStore(str(tmp_path))
    store.put(("cpu", "cpu0"), "fam[16x2,f32]", _entry())
    store.save()
    before = os.stat(store.path).st_mtime_ns
    os.utime(store.path, ns=(before - 10 ** 9, before - 10 ** 9))
    TuneStore(str(tmp_path)).save()
    assert os.stat(store.path).st_mtime_ns == before - 10 ** 9


@given(n=st.integers(1, 6), seed=st.integers(0, 10 ** 6))
@settings(max_examples=10, deadline=None)
def test_load_save_load_fixed_point(n, seed):
    entries = {}
    for i in range(n):
        fam = f"fam{(seed + i) % 7}[{i + 1}x2,f32]"
        entries[entry_key(("cpu", f"dev{i % 3}", "d1"), fam)] = {
            "cost_model": {"s3": {str(1 << i): (seed % 97 + 1) * 1e-5}},
            "ladder": [1, i + 1], "inner_chunk": i % 4,
            "queue_hist": {str(i + 1): seed % 13 + 1},
            "warmup_wave": i + 1, "tuned_by": "measured"}
    root = tempfile.mkdtemp(prefix="tunestore-prop-")
    store = TuneStore(root)
    for key, entry in entries.items():
        backend, device, topo, fam = key.split("|", 3)
        store.put((backend, device, topo), fam, entry)
    store.save()
    first = TuneStore(root)
    snapshot = first.entries()
    assert snapshot == entries
    first.save()
    assert TuneStore(root).entries() == snapshot


# ---------------------------------------------------------------------------
# executor round trip: cold measures and persists, warm restores
# ---------------------------------------------------------------------------

def test_executor_cold_then_warm(tmp_path):
    cold = _exe(_cfg(tmp_path))
    cold.warmup(SPECS)
    for _ in range(3):
        want = _run_wave(cold)
    region = _region(cold)
    assert region.stats["tuned_by"] == "measured"
    assert region.stats["measurement_launches"] > 0
    assert cold.save_tuning() == os.path.join(str(tmp_path),
                                              "tunestore.json")

    warm = _exe(_cfg(tmp_path))
    warm.warmup(SPECS)
    wregion = _region(warm)
    assert wregion.stats["tuned_by"] == "store"
    assert wregion.stats["warm_start"] is True
    assert warm.stats["warm_start"] is True
    assert wregion.buckets == region.buckets
    assert wregion.chunk == region.chunk
    assert wregion.tuned
    got = _run_wave(warm)
    assert torch.equal(got, want)
    assert torch.equal(got, 2.0 * PARENT + 1.0)
    assert wregion.stats["measurement_launches"] == 0
    srcs = wregion.stats["cost_sources"]
    assert srcs and all(v == "store" for tbl in srcs.values()
                        for v in tbl.values())
    # the stored tables are the cold process's medians
    assert wregion.stats["cost_model"] == region.stats["cost_model"]


def test_malformed_entry_falls_back_to_measuring(tmp_path):
    cold = _exe(_cfg(tmp_path))
    cold.warmup(SPECS)
    describe = _region(cold).signature.describe()
    store = TuneStore(str(tmp_path))
    bad = _entry()
    bad["ladder"] = ["not", "buckets"]
    store.put(_backend_key(CPU), describe, bad)
    store.save()

    exe = _exe(_cfg(tmp_path))
    with pytest.warns(TuneStoreWarning, match="unusable"):
        exe.warmup(SPECS)
    region = _region(exe)
    assert region.stats.get("tuned_by") != "store"
    assert not region.stats.get("warm_start")
    assert region.cost.measured()
    assert torch.equal(_run_wave(exe), 2.0 * PARENT + 1.0)


def test_stored_entry_for_other_device_is_invisible(tmp_path):
    probe = _exe(_cfg(tmp_path))
    probe.warmup(SPECS)
    describe = _region(probe).signature.describe()
    store = TuneStore(str(tmp_path))
    store.put(("cuda", "NVIDIA H100 80GB HBM3", "d1"), describe,
              _entry((1, 999)))
    store.put((*_backend_key(CPU)[:2], "d8"), describe, _entry((1, 999)))
    store.save()

    exe = _exe(_cfg(tmp_path))
    exe.warmup(SPECS)
    region = _region(exe)
    assert region.stats.get("tuned_by") != "store"
    assert 999 not in region.buckets


# ---------------------------------------------------------------------------
# roofline prior
# ---------------------------------------------------------------------------

def test_device_peaks_and_prior_shape():
    bw, flops, launch = device_peaks(("cpu", "cpu", "d1"))
    assert (bw, flops, launch) == DEVICE_PEAKS["cpu"] == (2.0e10, 5.0e10,
                                                           2.0e-5)
    assert device_peaks(("cuda", "NVIDIA H100 80GB HBM3", "d1"))[:2] == (
        3.35e12, 67e12)
    assert not any("tpu" in k for k in DEVICE_PEAKS)
    prior = RooflinePrior(("cpu", "cpu", "d1"))
    specs = (((2,), torch.float32),)
    t1, t8, t16 = (prior.predict(affine, specs, b) for b in (1, 8, 16))
    assert 0 < t1 < t8 < t16
    assert t8 - t1 == pytest.approx((t16 - t1) * 7 / 15)


def test_prior_reads_the_kernels_operation_count():
    """The hydro body's flops per task are ``kernels.counts``' (the count
    chip_smoke.py's bound divides), a body without a count gets the
    fallback intensity, and the output bytes come from a meta run."""
    cfg = HydroConfig(levels=1)
    body = ops.hydro_batched_body(cfg, 1.0 / 16)
    p, s = cfg.padded, cfg.subgrid
    specs = (((5, p, p, p), torch.float32),)
    prior = RooflinePrior(("cpu", "cpu", "d1"))
    flops, out_bytes = prior._analyze_family(body, specs)
    assert flops == counts.hydro_rhs_ops(1, s, cfg.ghost)
    assert out_bytes == 5 * s ** 3 * 4
    assert prior._analyze_family(affine, (((2,), torch.float32),)) == (
        FALLBACK_FLOPS_PER_ELEM * 2, 8.0)
    # the split pair and gravity carry their kernels' counts too
    split = ops.hydro_split_batched_body(cfg, 1.0 / 16)
    assert split.ops_per_task() == (counts.reconstruct_ops(1, p)
                                    + counts.flux_ops(1, s, cfg.ghost))


def test_chip_smoke_row_one_bound_reads_the_package_count():
    """The bound of the table's row 1 (``hydro_rhs`` on the Sedov IC's 512
    sub-grids of 8^3) still comes from 1.366 GFLOP and 33.3 MB."""
    import importlib.util
    import inspect
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mod", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert not hasattr(smoke, "hydro_rhs_ops")
    assert ("from repro_torch.kernels.counts import hydro_rhs_ops"
            in inspect.getsource(smoke.phase_kernel))
    n, p, s = 512, 14, 8
    n_ops = counts.hydro_rhs_ops(n, s, 3)
    n_bytes = (n * 5 * p ** 3 + n * 5 * s ** 3) * 4
    assert round(n_ops / 1e9, 3) == 1.366
    assert round(n_bytes / 1e6, 1) == 33.3
    ms, by = smoke.bound_ms(n_bytes, n_ops)
    assert by == "operations"
    assert ms == pytest.approx(n_ops / smoke.FP32_FLOP_PER_S * 1e3)


def test_prior_seeds_sane_ladder_without_measuring(tmp_path):
    exe = _exe(_cfg(tmp_path, prior="roofline"))
    exe.warmup(SPECS)
    region = _region(exe)
    assert region.stats["tuned_by"] == "prior"
    assert region.stats["measurement_launches"] == 0
    assert not region.cost.measured()
    assert region.cost.seeded() and region.cost.seeded("s2") \
        and region.cost.seeded("fused")
    assert validate_ladder(region.buckets, 16) == region.buckets
    srcs = region.stats["cost_sources"]
    assert all(v == "prior" for tbl in srcs.values() for v in tbl.values())
    assert not region.tuned


def test_prior_ladder_within_1p5x_of_tuned(tmp_path):
    exe = _exe(_cfg(tmp_path, prior="roofline"))
    exe.warmup(SPECS)
    prior_ladder = _region(exe).buckets
    measured = BucketCostModel()
    for b in range(1, 17):
        measured.record(b, 1.0 + 0.01 * b)
    tuned = derive_ladder({16: 1}, cap=16, budget=4, cost_model=measured)
    cost_prior = measured.predict_seq(greedy_decomposition(16, prior_ladder))
    cost_tuned = measured.predict_seq(greedy_decomposition(16, tuned))
    assert cost_prior <= 1.5 * cost_tuned


def test_retune_retires_prior_seeds(tmp_path):
    exe = _exe(_cfg(tmp_path, prior="roofline"))
    exe.warmup(SPECS)
    region = _region(exe)
    assert region.stats["tuned_by"] == "prior"
    for _ in range(3):
        got = _run_wave(exe)
    assert region.stats["tuned_by"] == "measured"
    assert not region.cost.priors
    srcs = region.stats["cost_sources"]
    assert all(v == "measured" for tbl in srcs.values()
               for v in tbl.values())
    assert torch.equal(got, 2.0 * PARENT + 1.0)
    # the retune wrote the tuned state back
    assert TuneStore(str(tmp_path)).get(
        _backend_key(CPU), region.signature.describe())["tuned_by"] == \
        "measured"


def test_bad_prior_mode_fails_fast(tmp_path):
    with pytest.raises(ValueError, match="prior"):
        _cfg(tmp_path, prior="bogus")


@pytest.mark.parametrize("route,want_s2,want_fused", [
    (None, True, True),
    ("s2", True, False),
    ("s3", False, False),
])
def test_explicit_route_skips_alt_probes(route, want_s2, want_fused):
    strategies = None if route is None else {"region": route}
    exe = _exe(_cfg(None, max_aggregated=8, family_strategies=strategies))
    exe.warmup((((8, 2), torch.float32),))
    region = _region(exe)
    assert region.cost.measured()
    assert region.cost.measured("s2") is want_s2
    assert region.cost.measured("fused") is want_fused


# ---------------------------------------------------------------------------
# the port held to the reference
# ---------------------------------------------------------------------------

def _jexecutor(cfg):
    """A reference executor on an always-idle pool whose timed samples
    are overwritten with ``TIMES`` (the port's injected times)."""
    exe = jagg.AggregationExecutor(jax.vmap(jaffine), cfg)
    exe.pool.any_idle = lambda: True
    measure = exe._measure_region

    def known_times(region, buckets, parents=None, ring_specs=None):
        measure(region, buckets, parents=parents, ring_specs=ring_specs)
        for path, table in region.cost._paths.items():
            for b, samples in table.items():
                samples[:] = [TIMES[path](b)] * len(samples)
    exe._measure_region = known_times
    return exe


@pytest.mark.parametrize("n,cap", [(16, 16), (24, 8)])
def test_persisted_entry_equals_reference(tmp_path, n, cap):
    """Same submissions, same known times: the port's stored entry is the
    reference's, field for field (only the key's backend part and the
    file's salt differ)."""
    parent = np.arange(2.0 * n, dtype=np.float32).reshape(n, 2)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jexe = _jexecutor(JAggregationConfig(**_kw(jdir, max_aggregated=cap)))
    exe = _exe(_cfg(pdir, max_aggregated=cap))
    jexe.warmup(parent_shapes=(jnp.asarray(parent),))
    exe.warmup((((n, 2), torch.float32),))
    for _ in range(3):
        jf = jexe.submit_range((jnp.asarray(parent),), 0, n)
        jexe.flush()
        f = exe.submit_range((torch.from_numpy(parent),), 0, n)
        exe.flush()
        np.testing.assert_array_equal(f.result().numpy(),
                                      np.asarray(jf.result()))
    jexe.save_tuning()
    exe.save_tuning()
    (jentry,) = jtunestore.TuneStore(str(jdir)).entries().values()
    (entry,) = TuneStore(str(pdir)).entries().values()
    assert entry["tuned_by"] == "measured"
    assert set(entry) == set(jentry)
    for field in jentry:
        assert entry[field] == jentry[field], field
    (jkey,) = jtunestore.TuneStore(str(jdir)).entries()
    (key,) = TuneStore(str(pdir)).entries()
    assert key.split("|")[3:] == jkey.split("|")[3:]   # the family part


@pytest.mark.parametrize("n,width,cap", [(16, 2, 16), (24, 3, 8)])
@pytest.mark.parametrize("ops_count", [None, 1.5e4])
def test_seeded_prior_equals_reference(monkeypatch, n, width, cap,
                                       ops_count):
    """At an equal per-task flop count the prior seeds the reference's
    tables (rel 1e-12) and derives its ladder."""
    def body(x, out=None):
        return affine(x, out=out)
    if ops_count is not None:
        body.ops_per_task = lambda: ops_count
    monkeypatch.setattr(jtunestore.RooflinePrior, "_xla_flops",
                        staticmethod(lambda fn, specs: ops_count))
    jexe = _jexecutor(JAggregationConfig(**_kw(None, max_aggregated=cap,
                                               prior="roofline")))
    jexe.warmup(parent_shapes=(jnp.zeros((n, width), jnp.float32),))
    exe = _exe(_cfg(None, max_aggregated=cap, prior="roofline"), body)
    exe.warmup((((n, width), torch.float32),))
    (jregion,) = jexe.regions.values()
    region = _region(exe)
    assert region.stats["tuned_by"] == jregion.stats["tuned_by"] == "prior"
    assert set(region.cost.priors) == set(jregion.cost.priors)
    for path, table in jregion.cost.priors.items():
        assert set(region.cost.priors[path]) == set(table)
        for b, t in table.items():
            assert region.cost.priors[path][b] == pytest.approx(t, rel=1e-12)
    assert tuple(region.buckets) == tuple(jregion.buckets)


def _write(store_cls, root):
    store = store_cls(str(root))
    store.put(("cpu", "cpu", "d1"), "region[2]", _entry())
    store.save()


@pytest.mark.parametrize("writer,reader", [
    ("jax", "port"), ("port", "jax")])
def test_stores_of_the_two_packages_are_stale_to_each_other(tmp_path, writer,
                                                            reader):
    """The salts hash each package's own sources, so a store written by
    one is ignored whole by the other, as between two code versions."""
    classes = {"jax": (jtunestore.TuneStore, jtunestore.TuneStoreWarning),
               "port": (TuneStore, TuneStoreWarning)}
    _write(classes[writer][0], tmp_path)
    assert len(classes[writer][0](str(tmp_path))) == 1
    with pytest.warns(classes[reader][1], match="salt"):
        assert len(classes[reader][0](str(tmp_path))) == 0
    assert code_salt() != jtunestore.code_salt()


# ---------------------------------------------------------------------------
# StrategyRunner: warmup(store=), save_tuning, the checkpoint's save
# ---------------------------------------------------------------------------

def test_runner_warm_start_and_checkpoint_save(tmp_path):
    u = sedov_init(SMALL, device="cpu").u
    dt = courant_dt(u, SMALL)
    tuned = dict(strategy="s3", max_aggregated=8, autotune=True,
                 autotune_warmup=1, cost_model=True, cost_samples=1)
    cold = StrategyRunner(UniformSedovScenario(SMALL), AggregationConfig(
        **tuned), device="cpu", timer=fake_timer())
    cold.warmup()
    want = cold.rk3_step(u, dt)
    assert cold.save_tuning() is None              # no store configured
    path = cold.save_tuning(store=str(tmp_path / "a"))
    assert path == str(tmp_path / "a" / "tunestore.json")
    (fam,) = cold.stats["regions"].values()
    assert fam["tuned_by"] == "measured"

    warm = StrategyRunner(UniformSedovScenario(SMALL), AggregationConfig(
        **tuned), device="cpu", timer=fake_timer())
    warm.warmup(store=str(tmp_path / "a"))
    (wfam,) = warm.stats["regions"].values()
    assert wfam["tuned_by"] == "store"
    assert wfam["ladder"] == fam["ladder"]
    assert wfam["measurement_launches"] == 0
    assert torch.equal(warm.rk3_step(u, dt), want)
    assert wfam["measurement_launches"] == 0

    # the checkpoint cadence saves the tuning (no retune here: autotune
    # off, the warmup's measured table is what it writes)
    store_dir, ckpt = tmp_path / "b", str(tmp_path / "ckpt")
    r = StrategyRunner(UniformSedovScenario(SMALL), AggregationConfig(
        strategy="s3", max_aggregated=8, cost_model=True, cost_samples=1,
        tune_store=str(store_dir)), device="cpu", timer=fake_timer())
    r.warmup()
    assert not (store_dir / "tunestore.json").exists()
    r.run(u, dt, 1, checkpoint_every=1, ckpt_dir=ckpt)
    assert latest_step(ckpt) == 1
    entry = TuneStore(str(store_dir)).get(_backend_key(CPU),
                                          next(iter(r.stats["regions"])))
    assert entry is not None and entry["cost_model"]["s3"]
