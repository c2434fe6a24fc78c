"""A call captured once as a CUDA graph over static inputs, then replayed.

``CapturedCall(fn, example_args, device)`` copies the example arguments
into static tensors it owns (a Python float becomes a 0-dim tensor of
the first tensor's dtype), runs ``warm`` (default ``fn``) once on a side
stream, then captures ``fn`` over the static inputs.  A call copies its
arguments into the static inputs on the caller's stream and replays the
graph there; it returns fresh copies of the graph's static outputs.  The
next replay overwrites the static outputs, and a result handed out may
still be read on another stream (an executor's launch) when it comes:
a copy is the caller's own tensor, which no later call touches and
which the caching allocator keeps, like any tensor, until every stream
that recorded it (``record_stream``) is done.

Before the capture, the warm call does every first-use thing outside the
graph: it builds and loads the kernel libraries, uploads their constant
tables, loads CUDA modules lazily loaded at a first launch, and fills the
caches that a body makes at first use (a tensor first made during the
capture lives in the graph's private pool and holds nothing until a
replay).  During the capture, a call that would synchronise with the host
(``.item()``, ``float(tensor)``, a pageable copy) raises at once
(``torch.cuda.set_sync_debug_mode("error")``), and so does anything else
the capture refuses: :class:`CaptureError`, never a quiet fallback to
eager calls.

Counters: the kernel wrappers count their launches while the call is
captured and while it warms; a replay launches the captured kernels
again without counting them.  What one replay launches is the graph's
own kernel nodes: :meth:`CapturedCall.kernel_names` lists them, read
from the captured ``cudaGraph_t`` through ``libcuda`` (the graph is kept
beside its executable instance for that).  The graph's memory pool
lives as long as the object.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

_KERNEL_NODE = 0           # CU_GRAPH_NODE_TYPE_KERNEL
_CHILD_GRAPH_NODE = 4      # CU_GRAPH_NODE_TYPE_GRAPH


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in (
            "gridDimX", "gridDimY", "gridDimZ", "blockDimX", "blockDimY",
            "blockDimZ", "sharedMemBytes")] + [
        ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.lru_cache(maxsize=1)
def _libcuda() -> ctypes.CDLL:
    """``libcuda`` with the signatures ``graph_kernel_names`` calls (each
    returns a ``CUresult``)."""
    cu = ctypes.CDLL("libcuda.so.1")
    ptr, name = ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)
    signatures = {
        "cuGraphGetNodes": (ptr, ctypes.POINTER(ptr),
                            ctypes.POINTER(ctypes.c_size_t)),
        "cuGraphNodeGetType": (ptr, ctypes.POINTER(ctypes.c_int)),
        "cuGraphChildGraphNodeGetGraph": (ptr, ctypes.POINTER(ptr)),
        "cuGraphKernelNodeGetParams_v2": (
            ptr, ctypes.POINTER(_KernelNodeParams)),
        "cuFuncGetName": (name, ptr),
        "cuKernelGetName": (name, ptr),
    }
    for fn, argtypes in signatures.items():
        getattr(cu, fn).argtypes = argtypes
        getattr(cu, fn).restype = ctypes.c_int
    return cu


def _check(fn: str, *args) -> None:
    err = getattr(_libcuda(), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} returned CUresult {err}")


def graph_kernel_names(graph_handle: int) -> List[str]:
    """The function name of every kernel node of a ``cudaGraph_t``
    (``CUgraph``), child graphs included, in node order: ``cuGraphGetNodes``,
    ``cuGraphNodeGetType``, ``cuGraphKernelNodeGetParams_v2`` and
    ``cuFuncGetName`` (or ``cuKernelGetName`` for a node that names its
    kernel by ``CUkernel``) of ``libcuda``, CUDA 12.3 or later."""
    graph = ctypes.c_void_p(graph_handle)
    n = ctypes.c_size_t(0)
    _check("cuGraphGetNodes", graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _check("cuGraphGetNodes", graph, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _check("cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value == _CHILD_GRAPH_NODE:
            child = ctypes.c_void_p()
            _check("cuGraphChildGraphNodeGetGraph", node, ctypes.byref(child))
            names += graph_kernel_names(child.value)
        elif kind.value == _KERNEL_NODE:
            params = _KernelNodeParams()
            _check("cuGraphKernelNodeGetParams_v2", node,
                   ctypes.byref(params))
            name = ctypes.c_char_p()
            if params.func:
                _check("cuFuncGetName", ctypes.byref(name), params.func)
            else:
                _check("cuKernelGetName", ctypes.byref(name), params.kern)
            names.append(name.value.decode())
    return names


class CaptureError(RuntimeError):
    """A call could not be captured as a CUDA graph."""


@contextlib.contextmanager
def _host_syncs_raise():
    prior = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prior)


class CapturedCall:
    """``fn(*tensors) -> tensor or tuple of tensors`` as one CUDA graph."""

    def __init__(self, fn: Callable, example_args: Sequence,
                 device: torch.device, warm: Optional[Callable] = None):
        dtype = next(a.dtype for a in example_args
                     if isinstance(a, torch.Tensor))
        self.inputs: Tuple[torch.Tensor, ...] = tuple(
            a.detach().clone() if isinstance(a, torch.Tensor)
            else torch.tensor(a, dtype=dtype, device=device)
            for a in example_args)
        caller = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            (warm or fn)(*self.inputs)
        caller.wait_stream(side)
        torch.cuda.synchronize(device)
        # kept: ``kernel_names`` reads the captured graph itself
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(torch.cuda.Stream(device)):
            self.graph.capture_begin()
            try:
                with _host_syncs_raise():
                    out = fn(*self.inputs)
            except Exception as err:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()   # an invalidated capture
                raise CaptureError(
                    f"the call cannot be captured as a CUDA graph: "
                    f"{err}") from err
            self.graph.capture_end()
        self.graph.instantiate()
        self.outputs = out

    def kernel_names(self) -> List[str]:
        """The function name of every kernel node of the captured graph:
        what one replay launches, kernel by kernel."""
        return graph_kernel_names(self.graph.raw_cuda_graph())

    def __call__(self, *args):
        """Copy ``args`` into the static inputs and replay, on the current
        stream; returns copies of the static outputs."""
        for static, a in zip(self.inputs, args):
            if isinstance(a, torch.Tensor):
                static.copy_(a)
            else:
                static.fill_(a)
        self.graph.replay()
        if isinstance(self.outputs, torch.Tensor):
            return self.outputs.clone()
        return tuple(o.clone() for o in self.outputs)
