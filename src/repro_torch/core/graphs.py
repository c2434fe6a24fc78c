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

:class:`BucketProgram` is one entry of a compiled-program table (the
aggregation regions', the ``s4`` regions' and the serving engine's): a
graph per launch site, captured over inputs that already live at fixed
addresses and never copied in (a slot ring's buffers, a region's static
parents), and each replay's kernels tallied for
:func:`replayed_kernels`.  :func:`make_program` files the eager callable
itself on the CPU and a :class:`BucketProgram` on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tracing

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


def capture_graph(fn: Callable, inputs: Sequence, device: torch.device,
                  warm: Optional[Callable] = None, pool=None):
    """``fn(*inputs)`` as one instantiated CUDA graph: ``warm`` (default
    ``fn``) runs once on a side stream first, then the call is captured on
    another under ``set_sync_debug_mode("error")``; returns ``(graph,
    outputs)``.  The host does not wait for the warm call: the capture
    records and runs nothing, and the caller's stream waits for the side
    stream, so a replay follows it; a first launch inside a drain leaves
    the host as free as an eager one.  The capture is thread-local: another
    thread's blocking CUDA call (the launch watchdog waiting on an event)
    leaves it valid.  Python's garbage collector is off while it records:
    a collection there could destroy another graph (programs and the
    regions that own them form reference cycles), which a capture
    refuses.  Anything the capture refuses raises :class:`CaptureError`."""
    caller = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        (warm or fn)(*inputs)
    caller.wait_stream(side)
    # kept: ``kernel_names`` reads the captured graph itself
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(torch.cuda.Stream(device)):
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                with _host_syncs_raise():
                    out = fn(*inputs)
            except Exception as err:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()   # an invalidated capture
                raise CaptureError(
                    f"the call cannot be captured as a CUDA graph: "
                    f"{err}") from err
            try:
                graph.capture_end()
            except RuntimeError as err:
                raise CaptureError(
                    f"the capture was invalidated: {err}") from err
    finally:
        if collecting:
            gc.enable()
    graph.instantiate()
    return graph, out


class CapturedCall:
    """``fn(*tensors) -> tensor or tuple of tensors`` as one CUDA graph
    (:func:`capture_graph`)."""

    def __init__(self, fn: Callable, example_args: Sequence,
                 device: torch.device, warm: Optional[Callable] = None):
        dtype = next(a.dtype for a in example_args
                     if isinstance(a, torch.Tensor))
        self.inputs: Tuple[torch.Tensor, ...] = tuple(
            a.detach().clone() if isinstance(a, torch.Tensor)
            else torch.tensor(a, dtype=dtype, device=device)
            for a in example_args)
        self.graph, self.outputs = capture_graph(fn, self.inputs, device,
                                                 warm)

    def kernel_names(self) -> List[str]:
        """The function name of every kernel node of the captured graph:
        what one replay launches, kernel by kernel."""
        return graph_kernel_names(self.graph.raw_cuda_graph())

    def replay_static(self, *args):
        """Copy ``args`` into the static inputs and replay, on the current
        stream; returns the static outputs themselves, which the next call
        overwrites (the caller orders its reads before that call)."""
        for static, a in zip(self.inputs, args):
            if isinstance(a, torch.Tensor):
                static.copy_(a)
            else:
                static.fill_(a)
        self.graph.replay()
        return self.outputs

    def __call__(self, *args):
        """Copy ``args`` into the static inputs and replay, on the current
        stream; returns copies of the static outputs."""
        out = self.replay_static(*args)
        if isinstance(out, torch.Tensor):
            return out.clone()
        return tuple(o.clone() for o in out)


# kernel nodes launched by bucket-program replays, by function name: what
# the kernel wrappers' counters no longer see once a launch is a replay
_REPLAYED: Counter = Counter()
# kernel launches the wrappers counted at bucket-program captures: the warm
# call launches each of the graph's kernel nodes once, and the recording
# calls each wrapper once more without launching it
_CAPTURED: Counter = Counter()


def replayed_kernels() -> Dict[str, int]:
    """Kernel launches made by :class:`BucketProgram` replays since the last
    :func:`reset_replayed_kernels`, by kernel function name (each replay
    counts its graph's kernel nodes)."""
    return dict(_REPLAYED)


def captured_kernels() -> Dict[str, int]:
    """What the kernel wrappers counted at :class:`BucketProgram` captures
    since the last :func:`reset_replayed_kernels`, by kernel function name
    (two per kernel node: the warm call and the recording).  A wrapper's
    count less these is its launches outside captures."""
    return dict(_CAPTURED)


def reset_replayed_kernels() -> None:
    _REPLAYED.clear()
    _CAPTURED.clear()


class _Site:
    """One launch site's graph: its inputs (fixed tensors held, so their
    identity stays theirs), static outputs, kernel nodes by name, the
    bytes a replay copies in and out, and the event of its last replay
    (with the copy out of its outputs)."""

    __slots__ = ("graph", "inputs", "outputs", "kernels", "copy_bytes",
                 "done")

    def __init__(self, graph, inputs, outputs, kernels, copy_bytes):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.kernels = kernels
        self.copy_bytes = copy_bytes
        self.done = None


class BucketProgram:
    """One compiled bucket program on the card: ``fn(*args)`` captured as a
    CUDA graph per launch site, replayed on the current stream.

    A graph bakes in its launch site: each non-tensor argument by value (a
    slot offset), each tensor argument by identity (a slot ring's buffer, a
    region's static parent: tensors that keep their address as long as the
    program; a fresh tensor per call would capture a graph per call), and
    each argument in ``copy_in`` (positions, or ``"all"``) by shape and
    dtype: its values, on the card or the host, are copied into the graph's
    own static input on the card at every call (an index tensor, a
    host-stacked bucket, a decode batch's slots and tokens).  A site is
    captured at its first call (:func:`capture_graph`: a warm call on a side
    stream, then the capture, without a host sync; the kernel wrappers count
    both, never a replay, and :func:`captured_kernels` tallies what they
    counted there).  ``sites`` maps each site to its graph;
    ``stats["captures"]`` and ``stats["graph_bytes"]`` (the device memory
    the captures reserved) count them, if given.

    A replay's outputs are copied out on the replaying stream (``copy_out``,
    the default), so a result handed out never changes afterwards.  The
    next replay of the same graph, on any stream, waits for the event
    recorded after that copy: CUDA orders a graph's launches after each
    other, not after a copy on another stream.  With ``copy_out=False`` the
    static outputs are returned and the caller reads them before the next
    call.  Every replay adds its graph's kernel nodes to
    :func:`replayed_kernels`.  ``pool`` shares one memory pool among
    programs that never run at once.  Each replay is a
    ``repro_torch.graphs.replay`` span tagged with ``tag`` (a kernel
    family), counting the bytes it copies."""

    def __init__(self, fn: Callable, device: torch.device, *,
                 copy_in: Any = (), copy_out: bool = True, pool=None,
                 stats: Optional[Dict[str, Any]] = None,
                 tag: Optional[str] = None):
        self.fn = fn
        self.device = device
        self.copy_in = copy_in
        self.copy_out = copy_out
        self.pool = pool
        self.stats = stats
        self.tag = tag
        self.sites: Dict[Tuple, Any] = {}

    def _copied(self, i: int) -> bool:
        return self.copy_in == "all" or i in self.copy_in

    def site(self, args: Sequence) -> Tuple:
        """The launch site of a call: what its graph bakes in."""
        key = []
        for i, a in enumerate(args):
            if not isinstance(a, torch.Tensor):
                key.append(("value", a))
            elif self._copied(i):
                key.append(("copy", tuple(a.shape), a.dtype))
            else:
                key.append(("fixed", id(a)))
        return tuple(key)

    def __call__(self, *args):
        key = self.site(args)
        site = self.sites.get(key)
        if site is None:
            site = self.sites[key] = self._capture(args)
            if self.stats is not None:
                self.stats["captures"] = self.stats.get("captures", 0) + 1
        return self._replay(site, args)

    def _capture(self, args: Sequence) -> _Site:
        inputs = tuple(a.detach().to(self.device, copy=True)
                       if isinstance(a, torch.Tensor) and self._copied(i)
                       else a for i, a in enumerate(args))
        before = torch.cuda.memory_reserved(self.device)
        graph, outputs = capture_graph(self.fn, inputs, self.device,
                                       pool=self.pool)
        if self.stats is not None:
            self.stats["graph_bytes"] = self.stats.get("graph_bytes", 0) + (
                torch.cuda.memory_reserved(self.device) - before)
        kernels = Counter(graph_kernel_names(graph.raw_cuda_graph()))
        _CAPTURED.update({k: 2 * n for k, n in kernels.items()})
        copied = [a for i, a in enumerate(inputs)
                  if isinstance(a, torch.Tensor) and self._copied(i)]
        if self.copy_out:
            copied += ([outputs] if isinstance(outputs, torch.Tensor)
                       else list(outputs))
        return _Site(graph, inputs, outputs, kernels, tracing.nbytes(copied))

    def _replay(self, site: _Site, args: Sequence):
        with tracing.span("repro_torch.graphs.replay", self.tag):
            tracing.add("copy_bytes", site.copy_bytes)
            stream = torch.cuda.current_stream(self.device)
            if site.done is not None:
                stream.wait_event(site.done)
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor) and self._copied(i):
                    site.inputs[i].copy_(a, non_blocking=True)
            site.graph.replay()
            out = (self._copy_out(site.outputs) if self.copy_out
                   else site.outputs)
            site.done = stream.record_event()
            _REPLAYED.update(site.kernels)
            return out

    @staticmethod
    def _copy_out(out):
        """The replay's outputs copied out of the static ones, on the
        current stream."""
        if isinstance(out, torch.Tensor):
            return out.clone()
        return type(out)(o.clone() for o in out)

    def kernel_names(self, key: Tuple) -> List[str]:
        """The kernel nodes one replay of the site ``key`` launches."""
        return list(self.sites[key].kernels.elements())


def make_program(fn: Callable, device: torch.device, **kw) -> Callable:
    """A compiled-program table's entry: ``fn`` itself on the CPU (the eager
    call), a :class:`BucketProgram` (``kw``) on the card."""
    if device.type != "cuda":
        return fn
    return BucketProgram(fn, device, **kw)
