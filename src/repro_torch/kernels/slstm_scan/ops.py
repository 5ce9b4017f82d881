"""Public wrapper of the sLSTM scan kernels (``csrc/slstm_scan.cu``).

Source note.  ``slstm_scan`` replaces the Pallas kernel
``slstm_scan_pallas`` (``src/repro/kernels/slstm_scan/slstm_scan.py:82``)
and, on the model path, the ``lax.scan`` ``_slstm_local_scan``
(``src/repro/models/recurrent.py:177``) that the JAX model runs.  It
takes one of three routes, chosen by :func:`scan_plan` from S and R's
dtype, sized by the shape (never by a failed build or launch):

- ``"step"`` (S = 1, a decode step): bound by the bytes of R.  A grid
  over (unit groups, heads) reads each CTA's four gate columns of R once
  from device memory in 16-byte loads; no scratch, no per-call query.
- ``"cluster"`` (S >= 2, bf16 R that fits a cluster of at most 16
  CTAs): bound by the latency of the S-step chain.  One thread block
  cluster of P CTAs per head (and batch group), each holding its units'
  gate columns of R in bf16 in shared memory; h_t goes to every CTA of
  the cluster by ``st.async`` into distributed shared memory, counted on
  a per-slot ``mbarrier``, with no round trip through L2.  The product
  runs on the tensor cores (h split into three exact bf16 pieces).  At
  hd = 512 P = 16 (128 KB of R each).  Heads are independent clusters,
  so H = 16 runs in waves.
- ``"coop"`` (S >= 2, f32 R; a head's f32 R at hd = 512 fits no 16-CTA
  cluster): the cooperative kernel, P = ceil(hd / 16) co-resident CTAs
  per head exchanging h_t through device memory; a grid that cannot be
  resident is refused with ``KernelError``.

One launch runs the whole sequence and returns the final (c, n, h, m)
from its single pass (the JAX model runs the scan a second time for it).
xpre is read through its strides in the model's batch-major
(B, S, 4, H, hd) layout; a time-major (S, B, 4, H, hd) array is taken as
its ``transpose(0, 1)`` view, with no copy.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to a kernel or raises; a fake tensor on any other device (a
dry run's card) takes the shape-only route (``common.shape_only``).
Each launch, real or shape-only, reports :func:`cost` to an active
``launch.cost.OpCounter``.  ``slstm_scan_launches`` counts every
kernel launch, and ``slstm_step_launches``, ``slstm_cluster_launches``
and ``slstm_coop_launches`` each route's.  ``cluster_occupancy`` holds
``cudaOccupancyMaxActiveClusters`` for each cluster configuration
launched, queried once per process before its first launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import logging
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.slstm_scan.ref import State, slstm_scan_ref
from repro_torch.launch.cost import report_kernel

DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("step", "cluster", "coop")

# the kernels' constants (csrc/slstm_scan.cu)
MAX_SHARED = 232448       # bytes of shared memory a CTA may use on sm_90
MAX_CLUSTER = 16          # CTAs a cluster (non-portable above 8)
CLUSTER_THREADS = 512
MAX_FINISH = 2            # (row, unit) items a cluster thread finishes
MAX_CHUNKS = 4            # chunks of 4 batch rows a cluster holds
STEP_THREADS = 256

slstm_scan_launches = 0
slstm_step_launches = 0
slstm_cluster_launches = 0
slstm_coop_launches = 0

# (x dtype, P, units, rows, smem) -> max active clusters (R is bf16)
cluster_occupancy: Dict[Tuple, int] = {}
_occupancy_lock = threading.Lock()
_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How one call runs.  ``ctas`` CTAs per head (the cluster size P on
    the cluster route) of ``units`` hidden units each; on the cluster
    route ``rows`` batch rows per cluster and ``groups`` clusters per
    head; ``smem`` bytes of dynamic shared memory per CTA (0 on the step
    route)."""
    route: str
    ctas: int
    units: int
    rows: int
    groups: int
    smem: int


def units_per_cta(hd: int) -> int:
    """Hidden units per CTA of the cooperative kernel: 16, or the next
    power of two >= hd when hd is smaller (one CTA per head)."""
    u = 1
    while u < min(hd, 16):
        u *= 2
    return u


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def cluster_smem(hd: int, units: int, rows: int) -> int:
    """Shared memory of one cluster CTA (``cluster_smem`` in the .cu): the
    two h slots' barriers (16 bytes); R's columns in bf16 as B fragments
    of [16 KT][C'], KT = ceil(hd / 16), C' = 4 Up rounded up to 64; the h
    slots [2][NC][hd] float4; the A fragments of h's three pieces [NC][KT]
    x 512 bytes; the k slices' partial sums [NC][KS][4][4 Up + 8] and the
    state (c, n, m) [4 NC][Up] in f32.  Up = units rounded up to pairs,
    NC the chunks of 4 rows, KS = 16 / NG slices for NG groups of 64
    columns (NG a power of two)."""
    up = units + (units & 1)
    c = 4 * up
    ng = 1
    while ng < _ceil(c, 64):
        ng *= 2
    ks = 16 // ng
    nc = _ceil(rows, 4)
    kt = _ceil(hd, 16)
    return (16 + kt * 16 * _ceil(c, 64) * 64 * 2 + 2 * nc * hd * 16
            + nc * kt * 512 + nc * ks * 4 * (c + 8) * 4 + 3 * nc * 4 * up * 4)


def _cluster_fits(hd: int, units: int, rows: int) -> bool:
    up = units + (units & 1)
    return (up <= 16 * 16 and _ceil(rows, 4) * 4 * up
            <= MAX_FINISH * CLUSTER_THREADS
            and cluster_smem(hd, units, rows) <= MAX_SHARED)


def scan_plan(b: int, s: int, h: int, hd: int,
              r_dtype: torch.dtype) -> ScanPlan:
    """The route of a call, a pure function of (B, S, H, hd, R's dtype):

    - S = 1: ``"step"``, ceil(hd / UC) CTAs a head of UC = 32 bytes of a
      gate row (16 bf16 or 8 f32 units);
    - S >= 2 and bf16 R: ``"cluster"`` with P the smallest power of two
      <= 16 whose slice of R (hd x 4 ceil(hd / P) in bf16) and the
      buffers of min(B, 4) rows fit a CTA's 227 KB; then as many chunks
      of 4 rows per cluster as fit (at most 4), ``groups`` = ceil(B /
      rows);
    - S >= 2 and f32 R, or bf16 R that no such P holds (hd >= 1024):
      ``"coop"``, the cooperative kernel with ``units_per_cta(hd)`` units
      a CTA."""
    if min(b, s, h, hd) < 1:
        raise ValueError(f"empty sLSTM scan (B, S, H, hd) = "
                         f"{(b, s, h, hd)}")
    if s == 1:
        uc = 32 // torch.empty((), dtype=r_dtype).element_size()
        return ScanPlan("step", _ceil(hd, uc), uc, b, 1, 0)
    p = 1
    while r_dtype == torch.bfloat16 and p <= MAX_CLUSTER:
        u = _ceil(hd, p)
        if _cluster_fits(hd, u, min(b, 4)):
            rows = min(b, 4)
            while rows < b and rows < 4 * MAX_CHUNKS and _cluster_fits(
                    hd, u, min(b, rows + 4)):
                rows = min(b, rows + 4)
            return ScanPlan("cluster", p, u, rows, _ceil(b, rows),
                            cluster_smem(hd, u, rows))
        p *= 2
    u = units_per_cta(hd)
    smem = 4 * (hd * 4 * u + hd * 4 + 256 * 4 + 3 * b * u)
    return ScanPlan("coop", _ceil(hd, u), u, b, 1, smem)


_CODE = {torch.float32: 0, torch.bfloat16: 1}


def max_active_clusters(plan: ScanPlan, x_dtype: torch.dtype, b: int,
                        h: int, hd: int,
                        device: Optional[torch.device] = None) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a cluster plan on ``device``
    (the current card by default): queried once per process and
    configuration (and logged), before that configuration's first launch.
    Fewer than H clusters is legal (the heads run in waves); none raises
    ``KernelError``."""
    key = (str(x_dtype), plan.ctas, plan.units, plan.rows, plan.smem)
    with _occupancy_lock:
        if key in cluster_occupancy:
            return cluster_occupancy[key]
        out = ctypes.c_int(0)
        common.launch(
            "slstm_scan cluster occupancy query",
            "mlego_slstm_cluster_occupancy",
            device if device is not None else torch.cuda.current_device(),
            _CODE[x_dtype], b, h, hd, plan.ctas, plan.units, plan.rows,
            plan.smem, ctypes.addressof(out))
        n = int(out.value)
        cluster_occupancy[key] = n
    _log.info("slstm_scan: %d clusters of %d CTAs (%d bytes of shared "
              "memory each) can be active at once (xpre %s, R bf16)", n,
              plan.ctas, plan.smem, x_dtype)
    if n < 1:
        raise common.KernelError(
            f"slstm_scan: no cluster of {plan.ctas} CTAs with {plan.smem} "
            f"bytes of shared memory fits this card")
    return n


def cost(b: int, s: int, h: int, hd: int, x_dtype: torch.dtype,
         r_dtype: torch.dtype) -> common.Cost:
    """One call's work: xpre and R read once, h_out written once, the
    state read and written once; the h·R products (2 · hd · 4hd flops per
    row, step and head) and ~20 f32 operations per unit for the gates.
    With bf16 R the f32 product is exact as three bf16 products on the
    tensor cores (h = hi + mid + lo), so it runs at a third of their peak;
    with f32 R at the fp32 peak."""
    x_el, r_el = x_dtype.itemsize, r_dtype.itemsize
    n_bytes = (b * s * 4 * h * hd * x_el + h * hd * 4 * hd * r_el
               + b * s * h * hd * x_el + 8 * 4 * b * h * hd)
    prod = 2 * b * s * h * hd * 4 * hd
    gates = (20 * b * s * h * hd, common.PEAK_F32_FLOPS)
    if r_el == 2:
        return common.Cost(n_bytes, ((3 * prod, common.PEAK_BF16_TC_FLOPS),
                                     gates), prod)
    return common.Cost(n_bytes, ((prod, common.PEAK_F32_FLOPS), gates),
                       prod)


def slstm_scan(xpre: torch.Tensor, r_mat: torch.Tensor, c0: torch.Tensor,
               n0: torch.Tensor, h0: torch.Tensor, m0: torch.Tensor
               ) -> Tuple[torch.Tensor, State]:
    """xpre: (B, S, 4, H, hd) gate pre-activations (z, i, f, o), float32
    or bfloat16; r_mat: (H, hd, 4 hd), float32 or bfloat16; state (c, n,
    h, m): (B, H, hd) float32.  Returns (h_out (B, S, H, hd) in xpre's
    dtype, the final (c, n, h, m) in float32), computed in float32.

    On the card the route is ``scan_plan(B, S, H, hd, r_mat.dtype)``; on
    the cooperative route all H * P CTAs must be resident at once, and a
    grid that cannot be is refused with ``KernelError``."""
    if xpre.dim() != 5 or xpre.shape[2] != 4:
        raise ValueError(f"xpre must be (B, S, 4, H, hd), got "
                         f"{tuple(xpre.shape)}")
    b, s, _, h, hd = xpre.shape
    if s < 1:
        raise ValueError("xpre holds no step (S = 0)")
    if tuple(r_mat.shape) != (h, hd, 4 * hd):
        raise ValueError(f"r_mat must be {(h, hd, 4 * hd)}, got "
                         f"{tuple(r_mat.shape)}")
    state = (c0, n0, h0, m0)
    for name, t in zip("cnhm", state):
        if tuple(t.shape) != (b, h, hd):
            raise ValueError(f"state {name} must be {(b, h, hd)}, got "
                             f"{tuple(t.shape)}")
    dev = common.same_device(xpre=xpre, r_mat=r_mat, c0=c0, n0=n0, h0=h0,
                             m0=m0)
    if dev.type == "cpu":
        return slstm_scan_ref(xpre, r_mat, c0, n0, h0, m0)
    common.require_cuda("xpre", xpre, dev, DTYPES, contiguous=False)
    common.require_cuda("r_mat", r_mat, dev, DTYPES)
    for name, t in zip("cnhm", state):
        common.require_cuda(f"state {name}", t, dev)
    plan = scan_plan(b, s, h, hd, r_mat.dtype)
    out = torch.empty((b, s, h, hd), dtype=xpre.dtype, device=dev)
    c1, n1, h1, m1 = (torch.empty((b, h, hd), dtype=torch.float32,
                                  device=dev) for _ in range(4))
    report_kernel("slstm_scan", dev, lambda: cost(b, s, h, hd, xpre.dtype,
                                                  r_mat.dtype))
    if common.shape_only(xpre):
        return out, (c1, n1, h1, m1)
    xc, rc = _CODE[xpre.dtype], _CODE[r_mat.dtype]
    xs_b, xs_s, xs_g, xs_h = xpre.stride()[:4]
    ptrs = (xpre, r_mat, c0, n0, h0, m0, out, c1, n1, h1, m1)
    stream = common.stream_of(xpre)
    what = f"slstm_scan ({plan.route} route)"
    if plan.route == "step":
        common.launch(what, "mlego_slstm_step", dev, *ptrs, xc, rc, b, h,
                      hd, xs_b, xs_g, xs_h, stream)
    elif plan.route == "cluster":
        max_active_clusters(plan, xpre.dtype, b, h, hd, dev)
        common.launch(what, "mlego_slstm_cluster", dev, *ptrs, xc, b, s, h,
                      hd, plan.ctas, plan.units, plan.rows, plan.smem, xs_b,
                      xs_s, xs_g, xs_h, stream)
    else:
        hbuf = torch.empty((2, b, h, hd), dtype=torch.float32, device=dev)
        arrive = torch.zeros(h, dtype=torch.int32, device=dev)
        common.launch(what, "mlego_slstm_coop", dev, *ptrs, hbuf, arrive,
                      xc, rc, b, s, h, hd, plan.units,
                      xs_b, xs_s, xs_g, xs_h, stream)
    common.count_launch(globals(), "slstm_scan_launches")
    common.count_launch(globals(), f"slstm_{plan.route}_launches")
    return out, (c1, n1, h1, m1)
