"""``BENCHMARK.json`` against the benchmark's contract, and a
configuration, a mix and a metric dropped into a copy of the folders,
found by name with no edit to a file that is there."""
import copy
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import manifest as mf
from portbench.tests import tiny

ROOT = mf.ROOT
MAN = mf.load()
CELLS = [w["name"] for w in MAN["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
ONE_LINE = 200
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _line(text):
    return 1 <= len(text) <= ONE_LINE and "\n" not in text and "\t" not in text


def test_keys_sizes_and_limits():
    assert set(MAN) == TOP_KEYS
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= len(MAN["configs"]) <= 24
    assert 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    for part, keys in KEYS.items():
        for entry in MAN[part]:
            extra = {"workloads"} if part in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, entry
    assert len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    for p in MAN["paths"]:
        assert len(p) <= 200 and ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir()


def test_names_units_and_lines_use_the_allowed_characters():
    names = []
    for part in KEYS:
        for entry in MAN[part]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((part, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for entry in MAN["configs"] + MAN["workloads"]:
        assert _line(entry["why"]), entry["why"]
    for entry in MAN["configs"]:
        assert _line(entry["source"]) and entry["source"].startswith("http")
    for entry in MAN["per_layer"]:
        assert _line(entry["layer"]), entry["layer"]
    for wl in MAN["workloads"]:
        assert NAME.match(wl["config"]) and NAME.match(wl["traffic"])
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    metric_names = [e["name"] for e in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({n for p, n in names if p == "workloads"}) == len(CELLS)
    assert len({n for p, n in names if p == "configs"}) == len(MAN["configs"])


def test_sources_bounds_and_setup():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["source"] == "device_trace"


def _reported(cell, part):
    return {m["name"] for m in MAN[part]
            if cell in m.get("workloads", [cell])}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = _reported(cell, "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert _reported(cell, "per_layer")


def test_moves_is_reported_wherever_the_metric_is():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert m["moves"] in _reported(cell, "end_to_end"), (m, cell)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert all(_line(layer) for layer in layers)
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


def test_every_config_has_a_cell_and_no_cell_four_chips():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    assert all(w["chips"] == 1 for w in MAN["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_name_has_its_file():
    paths = MAN["paths"]
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        data = mf.config(c["name"])
        assert (ROOT / c["file"]) == mf.HERE / "configs" / f"{c['name']}.json"
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert not set(c["reduced"]) - set(data)
    for w in MAN["workloads"]:
        assert (mf.HERE / "mixes" / f"{w['traffic']}.json").is_file()
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(mf.reader(m["name"]))


def _digest(folder: Path) -> str:
    h = hashlib.sha256()
    for f in sorted(folder.rglob("*")):
        if f.is_file() and "__pycache__" not in f.parts:
            h.update(str(f.relative_to(folder)).encode())
            h.update(f.read_bytes())
    return h.hexdigest()


@pytest.fixture
def copied(tmp_path):
    here = tmp_path / "portbench"
    for sub in ("configs", "mixes", "metrics", "kernel_names"):
        shutil.copytree(mf.HERE / sub, here / sub)
    return here


def test_new_config_mix_and_metric_are_found_by_name(copied, monkeypatch):
    before = _digest(mf.HERE)
    config = mf.config("sedov8")
    config["name"] = "sedov8-copy"
    (copied / "configs" / "sedov8-copy.json").write_text(json.dumps(config))
    mix = copy.deepcopy(mf.mix("l4-s3-cap512"))
    mix["aggregation"]["max_aggregated"] = 2
    (copied / "mixes" / "l1-s3-cap2.json").write_text(json.dumps(mix))
    (copied / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return float(run.window.steps)\n")
    man = copy.deepcopy(MAN)
    cell = "sedov8-copy.l1-s3-cap2"
    man["configs"].append({"name": "sedov8-copy", "source": config["source"],
                           "file": "portbench/configs/sedov8-copy.json",
                           "reduced": [], "why": "a copy"})
    man["workloads"].append({"name": cell, "config": "sedov8-copy",
                             "traffic": "l1-s3-cap2", "chips": 1,
                             "why": "a copy"})
    for m in man["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    man["per_layer"].append({"name": "steps_seen", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "setup_s",
                             "workloads": [cell]})
    monkeypatch.setitem(tiny.SIZES, "sedov8-copy", tiny.SIZES["sedov8"])
    result = tiny.run(cell, here=copied, manifest=man, trace=True)
    assert result["correct"] is True
    assert result["metrics"]["steps_seen"]["value"] >= 3
    plain = tiny.run(cell, here=copied, manifest=man)
    assert set(plain["metrics"]) == {"cell_updates_per_s", "step_ms_p95",
                                     "setup_s"}
    assert _digest(mf.HERE) == before
