"""Build and load the hand-written CUDA kernels (``loam_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled
by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
ctypes.  Libraries are keyed by a hash of their source, so an edited
kernel rebuilds and an unchanged one loads from ``_build/``.  Nothing
is built at import: the first launch builds (or ``build_all`` builds
every kernel in parallel, one nvcc per source).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("knn_topk", "odom_corr", "select_walk")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; None when the library is current."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=KERNEL_SOURCES) -> float:
    """Compile every kernel source concurrently; returns wall seconds."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in names}
    for name, job in jobs.items():
        _finish(name, job)
    return time.perf_counter() - t0


@functools.cache
def entry(name: str, argtypes: tuple):
    """The C entry point ``<name>_launch`` of csrc/<name>.cu, built if
    needed, with its signature declared (pointers and the stream as
    c_void_p) and an int cudaError_t result."""
    _finish(name, _start(name))
    fn = getattr(ctypes.CDLL(str(library_path(name))), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, dtype, shape, what: str) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
