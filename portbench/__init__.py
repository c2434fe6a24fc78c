"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout runs one cell
of ``BENCHMARK.json`` once and prints its result as the last line.

It imports neither JAX nor the JAX package ``repro``, and reads nothing of
the JAX package's own benchmark scripts or their result files.
"""
