"""The port's tracer (``repro_torch.tracing``): off it records nothing and
calls no torch op; on (``enable()`` or a running ``torch.profiler``) it
keeps one span tree per step on the profiler's clock, with the counts the
executor, the graphs and the exchange add.

The file imports neither JAX nor the reference, so its card tests run on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_tracing.py
"""
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import torch.autograd.profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    AggregationConfig, HydroConfig,
)
from repro_torch.core import StrategyRunner, UniformSedovScenario  # noqa: E402
from repro_torch.hydro.state import sedov_init  # noqa: E402
from repro_torch.hydro.stepper import courant_dt  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracing.disable()
    tracing.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tracing.disable()
    tracing.clear()


def _runner(levels: int, cap: int, device="cpu"):
    cfg = HydroConfig(levels=levels)
    runner = StrategyRunner(UniformSedovScenario(cfg),
                            AggregationConfig(strategy="s3",
                                              max_aggregated=cap),
                            device=device)
    runner.warmup(wave_only=True)
    return runner, cfg, sedov_init(cfg, device=device).u


def _steps(runner, cfg, u, n: int):
    for _ in range(n):
        u = runner.rk3_step(u, courant_dt(u, cfg))
    return u


def _raise(*a, **k):
    raise AssertionError("a profiler range opened with the tracer off")


def _on() -> bool:
    """Off, every span is the one shared null context."""
    return tracing.span("repro_torch.a") is not tracing.span("repro_torch.b")


def test_off_is_the_shared_null_context_and_calls_no_record_function(
        monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(tracing, "_mirror", _raise)
    monkeypatch.setattr(tracing, "nbytes", _raise)
    runner, cfg, u = _runner(levels=2, cap=16)
    a, b = tracing.span("repro_torch.x"), tracing.span("repro_torch.y", "t")
    assert a is b
    _steps(runner, cfg, u, 1)
    tracing.add("copy_bytes", 5)
    assert tracing.spans() == []
    assert tracing.dropped() == 0


def test_enabled_step_is_one_tree_per_step():
    runner, cfg, u = _runner(levels=1, cap=4)
    before = runner.stats["kernel_launches"]
    tracing.enable()
    _steps(runner, cfg, u, 2)
    tracing.disable()
    spans = tracing.spans()
    names = Counter(s.name for s in spans)
    assert names["repro_torch.rk3_step"] == 2
    assert names["repro_torch.courant_dt"] == 2
    assert names["repro_torch.stage"] == 6
    assert names["repro_torch.agg.launch"] == (
        runner.stats["kernel_launches"] - before)
    assert {s.tag for s in spans if s.name == "repro_torch.agg.launch"} == {
        "hydro_rhs"}
    by = {s.index: s for s in spans}
    for s in spans:
        if s.parent is None:
            assert s.name in ("repro_torch.rk3_step", "repro_torch.courant_dt")
            continue
        p = by[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert p.thread == s.thread
    for s in spans:
        if s.name == "repro_torch.stage":
            assert by[s.parent].name == "repro_torch.rk3_step"
        if s.name == "repro_torch.agg.stage":
            assert by[s.parent].name == "repro_torch.agg.launch"
    # no copies on the CPU: the programs are the eager calls
    assert not any(s.counts and s.counts.get("copy_bytes") for s in spans)


def test_a_running_profiler_records_spans_mirrored_on_the_shared_clock():
    runner, cfg, u = _runner(levels=1, cap=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert _on()
        u = _steps(runner, cfg, u, 1)
    spans = tracing.spans()
    assert Counter(s.name for s in spans)["repro_torch.rk3_step"] == 1
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("repro_torch.")]
    label = {}
    for s in spans:
        name = s.name if s.tag is None else f"{s.name}[{s.tag}]"
        label.setdefault(name, []).append(s)
    mirrors = {}
    for e in events:
        mirrors.setdefault(e.name(), []).append(e)
    assert set(mirrors) == set(label)
    assert "repro_torch.agg.launch[hydro_rhs]" in mirrors
    for name, ours in label.items():
        theirs = sorted(mirrors[name], key=lambda e: e.start_ns())
        assert len(theirs) == len(ours)
        for s, e in zip(sorted(ours, key=lambda s: s.start_ns), theirs):
            assert s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns
    n = len(spans)
    assert not _on()
    _steps(runner, cfg, u, 1)
    assert len(tracing.spans()) == n


def test_add_lands_on_the_innermost_open_span():
    tracing.enable()
    with tracing.span("repro_torch.rk3_step"):
        tracing.add("copy_bytes", 1)
        with tracing.span("repro_torch.agg.launch", "fam"):
            tracing.add("copy_bytes", 4)
            tracing.add("copy_bytes", 3)
            with tracing.span("repro_torch.agg.stage"):
                tracing.add("copy_bytes", 10)
        tracing.add("copy_bytes", 2)
    got = {s.name: s for s in tracing.spans()}
    assert got["repro_torch.rk3_step"].counts == {"copy_bytes": 3}
    assert got["repro_torch.agg.launch"].counts == {"copy_bytes": 7}
    assert got["repro_torch.agg.launch"].tag == "fam"
    assert got["repro_torch.agg.stage"].counts == {"copy_bytes": 10}
    assert got["repro_torch.agg.stage"].parent == \
        got["repro_torch.agg.launch"].index


def test_the_bound_drops_and_counts_what_it_cannot_keep(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 3)
    tracing.enable()
    for _ in range(5):
        with tracing.span("repro_torch.stage"):
            pass
    assert len(tracing.spans()) == 3
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_union_counts_concurrent_intervals_once():
    assert tracing.union_ns([]) == 0
    assert tracing.union_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4) + 1
    assert tracing.device_intervals(prof) == []


def test_serving_gather_and_scatter_record_through_the_tracer(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as model_mod
    from repro_torch.serving import Request, ServingEngine

    cfg = reduced(get_config("granite-8b"))
    m = model_mod.init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, m, max_batch=2, max_len=16, device="cpu")
    eng.submit(Request(0, [3, 1], max_new_tokens=2))
    monkeypatch.setattr(autograd_profiler, "record_function", _raise)
    monkeypatch.setattr(tracing, "_mirror", _raise)
    eng.step()
    assert tracing.spans() == []
    monkeypatch.undo()
    tracing.enable()
    eng.run()
    names = Counter(s.name for s in tracing.spans())
    assert names["repro_torch.serving.gather"] >= 1
    assert names["repro_torch.serving.gather"] == \
        names["repro_torch.serving.scatter"]


# -- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
def test_a_cuda_only_profile_records_program_spans(dev):
    runner, cfg, u = _runner(levels=1, cap=4, device=dev)
    _steps(runner, cfg, u, 1)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]):
        assert autograd_profiler._is_profiler_enabled
        _steps(runner, cfg, u, 2)
        torch.cuda.synchronize(dev)
    names = Counter(s.name for s in tracing.spans())
    assert names["repro_torch.rk3_step"] == 2
    assert names["repro_torch.courant_dt"] == 2
    assert (names["repro_torch.graphs.replay"]
            == names["repro_torch.agg.launch"])
    assert names["repro_torch.agg.launch"] == 2 * 3 * 2


@pytest.mark.requires_cuda
def test_a_host_and_device_profile_holds_the_launch_ranges(dev):
    runner, cfg, u = _runner(levels=1, cap=4, device=dev)
    _steps(runner, cfg, u, 1)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _steps(runner, cfg, u, 1)
        torch.cuda.synchronize(dev)
    events = list(prof.profiler.kineto_results.events())
    host = sorted((e for e in events
                   if e.name() == "repro_torch.agg.launch[hydro_rhs]"
                   and e.device_type() != torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.start_ns())
    ours = sorted((s for s in tracing.spans()
                   if s.name == "repro_torch.agg.launch"),
                  key=lambda s: s.start_ns)
    assert len(host) == len(ours) == 2 * 3
    for s, e in zip(ours, host):
        assert s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns
    assert all(not iv[1] < iv[0] for iv in tracing.device_intervals(prof))


@pytest.mark.requires_cuda
def test_copy_bytes_of_one_step_follow_from_the_shapes(dev):
    cap = 16
    runner, cfg, u = _runner(levels=2, cap=cap, device=dev)
    _steps(runner, cfg, u, 1)
    torch.cuda.synchronize(dev)
    tracing.enable()
    _steps(runner, cfg, u, 1)
    tracing.disable()
    torch.cuda.synchronize(dev)
    spans = tracing.spans()
    n, f, s = cfg.n_subgrids, cfg.n_fields, cfg.subgrid
    launches = n // cap
    # per stage: each bucket graph's output copied out; the sub-grids are
    # extracted straight into the static parent the graphs read, so the
    # launches copy no parent
    outputs = launches * cap * f * s ** 3 * 4
    by_name = Counter()
    for sp in spans:
        if sp.counts:
            by_name[sp.name] += sp.counts.get("copy_bytes", 0)
    assert by_name["repro_torch.agg.stage"] == 0
    assert by_name["repro_torch.graphs.replay"] == 3 * outputs
    assert sum(by_name.values()) == 3 * outputs
    assert runner.executor.stats["static_parent_copies"] == 0
