"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ``ctypes``.

A library is built at first use into ``src/repro_torch/_build/<hash>/``,
keyed by a hash of its source, every header beside it (``csrc/*.cuh``) and
the nvcc flags, so an edited source or header rebuilds and an unchanged one
loads at once.  Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a keeps wgmma/setmaxnreg available; no --use_fast_math: the KNP flux
# needs IEEE sqrt and division to stay within the reference's tolerance
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SMEM_PER_BLOCK = 232_448      # bytes of shared memory one sm_90 block may use

_LOCK = threading.Lock()                     # guards _NAME_LOCKS
_NAME_LOCKS: Dict[str, threading.Lock] = {}  # one per library
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, dict] = {}     # name -> {"seconds", "ptxas", "path"}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else nvcc on PATH."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and PATH): the CUDA kernels build only on a "
            "machine with the CUDA toolkit")
    return found


def output(out: Optional["torch.Tensor"], shape: Tuple[int, ...],
           like: "torch.Tensor", name: str,
           dtype: Optional["torch.dtype"] = None) -> "torch.Tensor":
    """A wrapper's output (float32 unless ``dtype``): a new tensor of
    ``shape`` on ``like``'s device, or the caller's ``out`` once checked to
    be exactly that — a contiguous tensor of that dtype and ``shape`` on
    the same device (a slice of a larger buffer is fine if it is
    contiguous)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if out is None:
        return torch.empty(shape, dtype=dtype, device=like.device)
    if (out.dtype != dtype or tuple(out.shape) != tuple(shape)
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(
            f"{name}: out= must be a contiguous {str(dtype)[6:]} "
            f"{tuple(shape)} tensor on {like.device}, got {out.dtype} "
            f"{tuple(out.shape)} on {out.device}"
            f"{'' if out.is_contiguous() else ', not contiguous'}")
    return out


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise before any build or launch when autograd records and an input
    requires a gradient: the kernels have no backward, so their result
    would carry none and the gradient would be lost without an error."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward, and an input requires a "
            f"gradient: train through the plain versions (ops.PLAIN_LM for "
            f"the serving kernels; the model's forward reaches no kernel) "
            f"or call it under torch.no_grad()")


def raise_on(err: int, error_string: Callable[[int], bytes],
             what: str) -> None:
    """Raise if a library call returned a CUDA error (``err`` != 0);
    ``error_string`` is the library's own cudaGetErrorString wrapper."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({error_string(err).decode()})")


def _digest(source: Path) -> str:
    """Key of one library: its source, every header in the source's
    directory (any of them may be included) and the nvcc flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(name: str,
         declare: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (cached per process).
    ``declare(lib)`` runs once, on load, to set argtypes and restypes.
    Threads may load different libraries at once: their nvcc processes run
    in parallel."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        source = CSRC / f"{name}.cu"
        out_dir = BUILD_DIR / _digest(source)
        target = out_dir / f"lib{name}.so"
        seconds: Optional[float] = None
        ptxas = ""
        if not target.is_file():
            out_dir.mkdir(parents=True, exist_ok=True)
            # build under a temporary name, then rename: a concurrent or
            # interrupted build never leaves a half-written library behind
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            ptxas = proc.stderr + proc.stdout
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed to build {source.name} "
                    f"(exit {proc.returncode}):\n{ptxas}")
            os.replace(tmp, target)
            (out_dir / f"{name}.ptxas.txt").write_text(ptxas)
        else:
            log = out_dir / f"{name}.ptxas.txt"
            ptxas = log.read_text() if log.is_file() else ""
        lib = ctypes.CDLL(str(target))
        if declare is not None:
            declare(lib)
        BUILD_LOG[name] = {"seconds": seconds, "ptxas": ptxas,
                           "path": str(target)}
        _LIBS[name] = lib
        return lib
