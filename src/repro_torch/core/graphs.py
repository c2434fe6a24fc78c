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
again without counting them.  The graph's memory pool lives as long as
the object.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import torch


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
        self.graph = torch.cuda.CUDAGraph()
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
        self.outputs = out

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
