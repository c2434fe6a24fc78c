"""PyTorch/CUDA port of ``repro``: the uniform Sedov blast wave under the
paper's aggregation strategies, with the fused hydro RHS as a hand-written
CUDA kernel for Hopper (``csrc/hydro_rhs.cu``).

Module and function names follow ``repro`` so each module's counterpart is
easy to find.  The port imports ``torch`` and ``numpy`` only; the JAX
package stays the reference it is tested against.
"""
