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
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple, Union

import torch
from torch._subclasses.fake_tensor import is_fake

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
    # stats, weights, out, b, n, kv, bias, base, stream
    "mlego_merge_topics_batched": (_P, _P, _P, _I, _I, _LL, _F, _F, _P),
    # stats, weights, row_offsets, out, n_segments, kv, bias, base, stream
    "mlego_merge_topics_ragged": (_P, _P, _P, _P, _I, _LL, _F, _F, _P),
    # host_ptrs, host_w, dev_table, dev_w, n, kv, bias, base, out, stream
    "mlego_merge_topics_parts": (_P, _P, _P, _P, _I, _LL, _F, _F, _P, _P),
    # host_ptrs, dev_table, dev_w, dev_offsets, n, n_segments, kv, bias,
    # base, out, stream
    "mlego_merge_topics_parts_segments": (_P, _P, _P, _P, _I, _I, _LL, _F,
                                          _F, _P, _P),
    # indptr, indices, values, eeb_t, gamma0, gamma, exp_elog_theta,
    # ratio, next_doc, D, K, R, alpha, n_iters, stream
    "mlego_vb_estep_csr_iters": (_P,) * 9 + (_I,) * 3 + (_F, _I, _P),
    # col_ptr, perm, rows, ratio, exp_elog_theta, eeb_t, sstats, K, V,
    # stream
    "mlego_vb_estep_csr_sstats": (_P,) * 7 + (_I, _I, _P),
    # words, mask, u, z_in, doc_ptr, slots, nkd_in, prior_t, prior_k,
    # z_out, nkd_out, nkv, n_docs, K, V, alpha, stream
    "mlego_gibbs_sweep_blocked": (_P,) * 12 + (_I,) * 3 + (_F, _P),
    # tokens, doc_ids, u, z, nkd, nkv_t, nk, g_t, gk, T, K, alpha, beta,
    # vbeta, stream
    "mlego_gibbs_sweep_exact": (_P,) * 9 + (_I, _I, _F, _F, _F, _P),
    # q, k, v, out, dtype, B, S, H, KVH, hd, 9 strides of q/k/v (b, s,
    # head), causal, window, scale, q_off, lse (or null), stream
    "mlego_flash_attention": (_P,) * 4 + (_I,) * 6 + (_LL,) * 9
    + (_I, _I, _F, _I, _P, _P),
    # q, k_cache, v_cache, pos, out, part_acc, part_ml, dtype, B, S, H,
    # KVH, hd, 8 strides (q: b, head; k, v: b, s, head), window, scale,
    # n_split, chunk, lse (or null), stream
    "mlego_decode_attention": (_P,) * 7 + (_I,) * 6 + (_LL,) * 8
    + (_I, _F, _I, _I, _P, _P),
    # xpre, r_mat, c0, n0, h0, m0, out, c1, n1, h1, m1, x_dtype, r_dtype,
    # B, H, hd, 3 strides of xpre (b, gate, head), stream
    "mlego_slstm_step": (_P,) * 11 + (_I,) * 5 + (_LL,) * 3 + (_P,),
    # the same 11 pointers (R in bf16), x_dtype, B, S, H, hd, P, units,
    # rows, smem bytes, 4 strides of xpre (b, s, gate, head), stream
    "mlego_slstm_cluster": (_P,) * 11 + (_I,) * 8 + (_LL,) * 5 + (_P,),
    # x_dtype, B, H, hd, P, units, rows, smem bytes, &clusters
    "mlego_slstm_cluster_occupancy": (_I,) * 7 + (_LL, _P),
    # the same 11 pointers, hbuf, arrive, x_dtype, r_dtype, B, S, H, hd,
    # units, 4 strides of xpre (b, s, gate, head), stream
    "mlego_slstm_coop": (_P,) * 13 + (_I,) * 7 + (_LL,) * 4 + (_P,),
}


# one H100 SXM's published peaks (data sheet, 700 W): HBM bytes/s, fp32
# (CUDA-core) flop/s and dense bf16 tensor-core flop/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12


@dataclasses.dataclass(frozen=True)
class Cost:
    """What one call of a kernel must do: ``n_bytes`` (each input read
    once, each output written once), ``ops`` ((operations, peak rate)
    pairs: the work at the rate it can run) and ``flops`` (its products'
    FLOPs, 2 a multiply-add: what a dry run's counter adds, as it counts
    the plain ops' products).  Each kernel package's ``cost(...)`` gives
    it for one call's shapes; ``chip_smoke.py``'s bound column and the
    shape-only routes read the same function."""

    n_bytes: float
    ops: Tuple[Tuple[float, float], ...]
    flops: float = 0.0

    def bound_ms(self) -> Tuple[float, str]:
        """The least time the card could take, in ms, and what bounds it:
        the bytes at the HBM rate or the operations at their peaks."""
        t_bytes = self.n_bytes / PEAK_BYTES_S * 1e3
        t_ops = 0.0
        for n, rate in self.ops:
            t_ops += n / rate
        t_ops *= 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")


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
    """Handle of the current PyTorch stream on ``t``'s device (0 for a
    fake tensor, which ``launch`` refuses)."""
    if is_fake(t):
        return 0
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(what: str, entry: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with ``device`` made current and
    raise ``KernelError`` if it returns a nonzero status.

    A tensor among ``args`` is passed as its data pointer, taken here: a
    fake tensor (``FakeTensorMode``: shapes, no storage, a null pointer)
    raises ``KernelError`` before anything is loaded or launched.

    Every entry point launches onto the stream it is handed
    (``stream_of``: the current stream of a tensor's device), and CUDA
    refuses a launch onto a stream of a device that is not current; so a
    tensor on any card of a host launches where it lies, whichever card
    the calling thread had current."""
    ptrs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if is_fake(a):
                raise KernelError(
                    f"{what}: a fake tensor {tuple(a.shape)} on {a.device} "
                    f"has no storage to launch on")
            a = a.data_ptr()
        ptrs.append(a)
    fn = getattr(load_library(), entry)
    with torch.cuda.device(device):
        status = fn(*ptrs)
    check_launch(status, what)


_count_lock = threading.Lock()


def count_launch(counters: dict, name: str, n: int = 1) -> None:
    """Add ``n`` to the launch counter ``name`` of a wrapper module
    (``counters`` is that module's ``globals()``)."""
    with _count_lock:
        counters[name] += n


def same_device(**tensors: torch.Tensor) -> torch.device:
    """The one device (CPU or CUDA) all the named tensors lie on; fake
    tensors (a dry run's cards) may lie on any."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{ {n: str(t.device) for n, t in tensors.items()} }")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda") and not all(
            is_fake(t) for t in tensors.values()):
        raise ValueError(f"unsupported device {dev}")
    return dev


def shape_only(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` (on a device other than the CPU) takes
    its shape-only route: ``t`` is a fake tensor, which holds shapes and
    no storage.  The route runs the wrapper's checks and returns empty
    outputs of the kernel's shapes and dtypes (its launch, like a real
    one, is reported to an active ``launch.cost.OpCounter``); it computes
    nothing, and no real tensor takes it."""
    return is_fake(t)


def require_cuda(name: str, t: torch.Tensor, device: torch.device,
                 dtype: Union[torch.dtype, Tuple[torch.dtype, ...]]
                 = torch.float32, contiguous: bool = True) -> None:
    """Checks the kernels rely on: CUDA, one of the dtypes the kernel
    takes, one device, and either a contiguous tensor or (for kernels
    that read through strides, ``contiguous=False``) a contiguous last
    dimension; and no gradient asked of it.  A kernel writes its output
    through a raw pointer, so the output has no ``grad_fn``: an input
    that requires grad while grad mode is on raises ``ValueError`` rather
    than give a silently zero gradient."""
    if torch.is_grad_enabled() and t.requires_grad:
        raise ValueError(
            f"{name} requires grad, and the CUDA kernels have no backward: "
            f"train through Model.loss, whose attention is "
            f"models.attention.ring_attention and whose sLSTM is "
            f"models.recurrent.slstm_train, or call the kernel under "
            f"torch.no_grad()")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not contiguous and t.dim() and t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dimension")


def require_aligned16(name: str, t: torch.Tensor) -> None:
    """Checks of a kernel that copies rows of ``t`` in 16-byte pieces:
    the data pointer 16-byte aligned and every stride but the last (which
    must be 1) a whole number of 16-byte pieces."""
    piece = 16 // t.element_size()
    # a fake tensor has no pointer: its offset into its storage stands in
    # (an allocation starts on a 512-byte boundary)
    ptr = (t.storage_offset() * t.element_size() if is_fake(t)
           else t.data_ptr())
    if ptr % 16 != 0 or any(st % piece for st in t.stride()[:-1]):
        raise ValueError(
            f"{name} must start on a 16-byte boundary with strides that are "
            f"multiples of {piece} elements; got data_ptr % 16 = "
            f"{ptr % 16}, strides {tuple(t.stride())}")
