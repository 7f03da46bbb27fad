"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries go
to ``build/singa_tpu_torch/`` at the root of the checkout, named by a hash of
their sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is. Nothing is compiled when a module is imported: the first
launch builds, or ``build_all()`` builds every kernel at once, one ``nvcc``
process per source, all started together.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "singa_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [os.path.join(CSRC, f"{name}.cu")] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path) or
    None when the library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for one nvcc; returns its output (register/shared-memory report)."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return log


def build_all(names=None) -> dict[str, str]:
    """Build every kernel source in parallel; returns nvcc's output by name."""
    names = names or sorted(
        os.path.splitext(os.path.basename(p))[0] for p in glob.glob(os.path.join(CSRC, "*.cu"))
    )
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, job) for n, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


INVALID_VALUE = 1  # cudaErrorInvalidValue: the entry points' answer to a shape they do not take


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``: a
    ValueError for a shape the kernel does not take (each entry point checks
    its own limits: channel multiples, rows, shared memory), else a
    RuntimeError."""
    if status == INVALID_VALUE:
        raise ValueError(f"{what}: the kernel does not take these shapes (cudaErrorInvalidValue)")
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def aligned(t):
    """``t`` itself where its data starts on a 16-byte boundary (or it is
    None), else a contiguous copy, whose fresh allocation does. The kernels
    read their inputs with 16-byte loads (``cp.async``, ``float4``), which
    fault on a contiguous view at a storage offset that is not a multiple of
    4 floats; with the copy each kernel takes every input the JAX package
    takes. Each wrapper passes its tensor inputs through it before the
    launch and keeps the result alive until then."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    import torch

    return t.clone(memory_format=torch.contiguous_format)


def require(t, name: str, shape: tuple, dtype, device) -> None:
    """Check one kernel argument: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
