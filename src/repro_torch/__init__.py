"""PyTorch/CUDA port of ``repro``: the Sedov blast wave (uniform,
self-gravitating and two-level AMR) under the paper's aggregation
strategies, with every hydro and gravity kernel hand-written in CUDA for
Hopper (``csrc/``).

Module and function names follow ``repro`` so each module's counterpart is
easy to find.  The port imports ``torch`` and ``numpy`` only; the JAX
package stays the reference it is tested against.
"""
