"""What the benchmark loads: no JAX and no JAX package in a run, nothing
of the program in the reference; top-level module names compared whole,
so ``repro_torch`` is not ``repro``."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
JAX = {"jax", "jaxlib", "flax", "repro"}


def _python(code: str) -> dict:
    """Run ``code`` in a fresh interpreter from the repository's root (no
    test process's imports) and return the JSON it prints last."""
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_whole_run_loads_no_jax_nor_the_jax_package():
    """A traced run of a cell at the tiny size, the program's modules
    loaded: the run's own end-of-run check and ``sys.modules``."""
    out = _python(
        "import json, sys, torch\n"
        "from portbench import harness\n"
        "from portbench.tests import tiny\n"
        "r = tiny.run('amr-sedov8.c16-s3-cap512', trace=True)\n"
        "tops = sorted({m.partition('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'correct': r['correct'], 'tops': tops,\n"
        "                  'found': harness.forbidden_modules()}))\n")
    assert out["correct"] is True
    assert "repro_torch" in out["tops"]
    assert not JAX & set(out["tops"])
    assert out["found"] == []


def test_the_reference_loads_nothing_of_the_program():
    out = _python(
        "import json, sys\n"
        "import portbench.reference.step, portbench.reference.grid\n"
        "import portbench.compare, portbench.initial, portbench.yardstick\n"
        "print(json.dumps(sorted({m.partition('.')[0]\n"
        "                         for m in sys.modules})))\n")
    assert "torch" in out
    assert not (JAX | {"repro_torch"}) & set(out)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("folder,banned", (
    ("reference", JAX | {"repro_torch"}),
    (".", JAX)))
def test_no_source_imports_a_banned_name(folder, banned):
    for path in (HERE / folder).rglob("*.py"):
        if folder == "." and path.parent.name == "tests":
            continue
        for name in _imports(path):
            assert name.partition(".")[0] not in banned, (path, name)


def test_no_source_reads_the_jax_package_results():
    for path in HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path


def test_forbidden_names_compare_whole():
    clean = ["torch", "repro_torch", "repro_torch.core", "reprox",
             "jaxtyping", "flaxen.x"]
    assert harness.forbidden_modules(clean) == []
    assert harness.forbidden_modules(clean + ["repro.core", "jax.numpy",
                                              "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "repro"]
