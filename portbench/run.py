"""Run one cell of ``BENCHMARK.json`` once, on the card this process sees.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The last line of standard output is the result (JSON); standard error
ends with each compared number beside its limit.  Exits 4 without a card
(or with fewer than the cell asks for) or without the program beside this
folder, and 5 if the run loaded JAX or the JAX package.  Every cache a run
writes stays in ``.portbench/`` of the checkout.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench", "cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
# the benchmark's package and the program; not this folder, whose module
# names would shadow others
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
