"""``BENCHMARK.json`` and the files it names, found by name.

A cell (a ``workloads`` entry) names a configuration and a traffic mix:
``configs/<config>.json`` and ``mixes/<traffic>.json`` under this folder.
Every metric, end to end or per layer, is ``metrics/<name>.py`` with
``read(run)``, returning its value or None when the run has nothing for it
to read (the harness then leaves it out of the line).  A new cell,
mix or metric is a new file and a new entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; known: "
                     f"{[w['name'] for w in manifest['workloads']]}")


def config(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "configs" / f"{name}.json").read_text())


def mix(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "mixes" / f"{name}.json").read_text())


def reader(metric: str, here: Path = HERE) -> Callable:
    """``metrics/<metric>.py``'s ``read``, loaded from its file."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(manifest: dict, cell: str, run, here: Path = HERE,
                 kind: str = "end_to_end") -> Dict[str, dict]:
    """Every metric of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports and that finds something to read."""
    out = {}
    for m in manifest[kind]:
        if cell not in m.get("workloads", [cell]):
            continue
        value: Optional[float] = reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
