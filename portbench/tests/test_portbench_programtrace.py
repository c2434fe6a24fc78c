"""The split of a traced sub-window's device idle by the program's spans
(``portbench/programtrace.py``), on synthetic device operations and
spans, and the new metrics on a tiny traced CPU run."""
from portbench import programtrace
from portbench.tests import tiny
from repro_torch.tracing import Span

NEW = ("dt_idle_ms_per_step", "scenario_idle_ms_per_step",
       "executor_idle_ms_per_step", "copy_mb_per_step")
# device busy 10-20, 30-40, 60-100: the extent is 10-100, idle 20-30, 40-60
OPS = [("k", 10, 20), ("k", 30, 40), ("memcpy", 60, 100)]


def _span(index, name, start, end, parent=None, thread=1, counts=None,
          tag=None):
    return Span(index, name, tag, start, end, parent, thread, counts)


def _spans():
    return [
        _span(0, "repro_torch.courant_dt", 5, 25),
        _span(1, "repro_torch.rk3_step", 26, 95),
        _span(2, "repro_torch.stage", 27, 90, parent=1),
        _span(3, "repro_torch.scenario.populations", 28, 35, parent=2),
        _span(4, "repro_torch.agg.submit", 36, 50, parent=2),
        _span(5, "repro_torch.agg.launch", 41, 45, parent=4, tag="f"),
        _span(6, "repro_torch.graphs.replay", 42, 44, parent=5, tag="f",
              counts={"copy_bytes": 100}),
        _span(7, "repro_torch.agg.flush", 52, 55, parent=2),
        # outside the extent: another step, with its own copies
        _span(8, "repro_torch.rk3_step", 200, 300),
        _span(9, "repro_torch.agg.stage", 210, 220, parent=8,
              counts={"copy_bytes": 999}),
        # another thread, over the extent
        _span(10, "repro_torch.agg.launch", 20, 60, thread=2,
              counts={"copy_bytes": 7}),
    ]


def test_parts_sum_to_the_idle_and_the_innermost_span_wins():
    got = programtrace.split(OPS, _spans(), steps=1)
    # 20-25 dt; 25-26 outside; 26-28 the runner (rk3_step, then stage);
    # 28-30 scenario (inside the stage); 40-50 and 52-55 the executor;
    # 50-52 and 55-60 the stage itself
    assert got["parts"] == {"dt": 5, "scenario": 2, "executor": 13,
                            "runner": 9, "outside": 1}
    assert got["idle_ns"] == 30
    assert sum(got["parts"].values()) == got["idle_ns"]
    assert got["copy_bytes"] == 100
    assert got["steps"] == 1


def test_spans_outside_the_extent_are_ignored_and_a_step_mismatch_is_none():
    base = programtrace.split(OPS, _spans(), steps=1)
    far = _spans() + [_span(11, "repro_torch.courant_dt", 120, 130),
                      _span(12, "repro_torch.scenario.exchange", 0, 9)]
    assert programtrace.split(OPS, far, steps=1) == base
    assert programtrace.split(OPS, _spans(), steps=2) is None
    assert programtrace.split([], _spans(), steps=1) is None
    # no program span at all: every idle instant lies outside
    bare = [_span(0, "repro_torch.rk3_step", 0, 1000)]
    got = programtrace.split(OPS, bare, steps=1)
    assert got["parts"]["runner"] == 30 and got["copy_bytes"] == 0


def test_a_span_that_outlasts_its_parent_is_cut_at_its_end():
    runs = programtrace.labelled([(0, 10, "runner"), (5, 20, "executor")],
                                 0, 30)
    assert runs == [(0, 5, "runner"), (5, 10, "executor"),
                    (10, 30, "outside")]


def test_a_tiny_traced_cpu_run_reports_none_of_the_new_metrics():
    r = tiny.run("sedov8.l4-s3-cap512", trace=True)
    assert r["correct"] is True
    assert not set(NEW) & set(r["metrics"])
