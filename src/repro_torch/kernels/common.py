"""Device resolution and the build/bind path of the port's CUDA kernels.

Every kernel of ``repro_torch`` is CUDA C++ under ``kernels/csrc/``,
compiled for Hopper (``sm_90a``) by ``nvcc`` into one shared library
with a plain C interface and bound with ``ctypes``.  The build runs on
first use, never at import: the CPU-only test hosts import every module
and have no ``nvcc``.  Each source compiles in its own ``nvcc`` process
(all started together), then one link step makes the library; its file
name carries a hash of the sources and flags, so an unchanged tree
loads the library it already built under ``build/repro_torch_kernels/``.

Every C entry point returns ``cudaGetLastError()`` right after its
launch; :func:`check_launch` raises :class:`KernelError` when that is
not 0.  ``KernelError`` is a *permanent* execution error — not a
``DeviceLostError`` — so a broken kernel fails the query instead of
being replayed quietly on the host backend.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch.core.errors import PermanentExecutionError

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signature of every entry point in csrc/ (all return a cudaError_t)
_SIGNATURES = {
    # stats, weights, out, n, kv, bias, base, stream
    "mlego_merge_topics": (_P, _P, _P, _I, _LL, _F, _F, _P),
    # stats, weights, row_offsets, out, n_segments, kv, bias, base, stream
    "mlego_merge_topics_ragged": (_P, _P, _P, _P, _I, _LL, _F, _F, _P),
    # x, exp_elog_beta, gamma0, gamma, exp_elog_theta, D, K, V, alpha,
    # n_iters, stream
    "mlego_vb_estep_iters": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # x, exp_elog_beta, exp_elog_theta, sstats, D, K, V, stream
    "mlego_vb_estep_sstats": (_P, _P, _P, _P, _I, _I, _I, _P),
}


class KernelError(PermanentExecutionError):
    """A kernel failed to build or its launch returned a CUDA error."""


class DeviceUnavailableError(RuntimeError):
    """A CUDA device was asked for on a host where torch sees none."""


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another.  Asking for CUDA where none is available raises —
    nothing carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # the index a tensor or generator created on "cuda" reports
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmlego_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelError("nvcc not found: the CUDA toolkit is needed to build "
                      "the repro_torch kernels")


def build_library() -> Path:
    """Compile ``csrc/*.cu`` (one ``nvcc`` per source, in parallel) and
    link them into the hashed library; a no-op when it already exists.
    Compiler output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    cu, _ = _sources()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in cu:
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (rc={p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise KernelError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = tmp / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp_so), *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise KernelError("linking the kernel library failed:\n"
                              + "\n".join(log))
        so.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def load_library() -> ctypes.CDLL:
    """Build on first use, load once per process, declare signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build_library()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            raise KernelError(f"cannot load {path}: {exc}") from exc
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.mlego_error_string.argtypes = [ctypes.c_int]
        lib.mlego_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def build_log() -> str:
    """Compiler output of the library build ('' before a build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check_launch(status: int, what: str) -> None:
    """Raise ``KernelError`` for a nonzero status from a C entry point."""
    if status != 0:
        msg = load_library().mlego_error_string(status).decode()
        raise KernelError(f"{what} launch failed: CUDA error {status} "
                          f"({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current PyTorch stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_f32(name: str, t: torch.Tensor,
                     device: torch.device) -> None:
    """Checks the kernels rely on: CUDA, float32, contiguous, one device."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
