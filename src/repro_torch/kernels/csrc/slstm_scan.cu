// sLSTM scan for Hopper: S dependent steps of the sLSTM recurrence from a
// given state, for every head at once.
//
//   rec_t      = h_{t-1} R                  (per head: hd -> 4 hd, z i f o)
//   tot        = xpre_t + rec_t
//   m_t        = max(logsig(f) + m_{t-1}, i)
//   c_t        = exp(logsig(f) + m_{t-1} - m_t) c_{t-1} + exp(i - m_t) tanh(z)
//   n_t        = exp(logsig(f) + m_{t-1} - m_t) n_{t-1} + exp(i - m_t)
//   h_t        = sigmoid(o) c_t / max(n_t, 1e-6)
//
// xpre (B, S, 4, H, hd) in f32 or bf16, read through its strides (the last
// dimension must be contiguous); R (H, hd, 4 hd) in f32 or bf16 (the served
// model's R is bf16); state (c, n, h, m) (B, H, hd) f32.  Writes h_out
// (B, S, H, hd) in xpre's dtype and the final state in f32.  All arithmetic
// is f32; the transcendental functions are the full-precision ones.
//
// Replaces the Pallas kernel slstm_scan_pallas
// (src/repro/kernels/slstm_scan/slstm_scan.py:82), and with it the lax.scan
// _slstm_local_scan (src/repro/models/recurrent.py:177) that the JAX model
// runs in prefill and decode.
//
// Three routes; the wrapper (slstm_scan/ops.py, scan_plan) picks one from
// S and R's dtype (and the shape for the cluster size), never by a failed
// launch:
//
// 1. step (S = 1, every decode step).  Bound: bytes.  The step reads all
//    of R once (8 MB of bf16 at H = 4, hd = 512: 2.5 us at 3.35 TB/s) and
//    nothing depends on another CTA.  Grid (hd / UC, H): a CTA owns UC
//    units (32 bytes of each gate row: 16 bf16 or 8 f32) and reads its four
//    gate columns of R straight from device memory in 16-byte loads, eight
//    lanes a k row, 32 k rows a pass, up to 16 loads a thread in flight
//    before the first is used (h0's rows are staged in shared memory
//    meanwhile); the k slices are summed in a fixed order (shuffles in the
//    warp, then the 8 warps through shared memory) and 4 x UC threads
//    finish the gates.  No scratch, no per-call query.
//
// 2. cluster (S >= 2, bf16 R that fits a cluster of <= 16 CTAs).  Bound:
//    latency.  Step t needs all of h_{t-1}, so a prefill is a chain of S
//    steps, and a step's work (B hd 4hd FMAs a head) is small.  One thread
//    block cluster of P CTAs per head (grid (P, H, G), cluster (P, 1, 1);
//    P is the smallest power of two for which a CTA's slice of R, in bf16,
//    fits its shared memory: 16 at hd = 512, 128 KB each).  A CTA owns
//    U = hd / P units and keeps their four gate columns (hd x 4U,
//    unit-major: column 4 lu + g) in shared memory for the whole call.
//    Every step:
//     - one warp waits on slot (t - 1) & 1's mbarrier until all of h_{t-1}
//       has arrived; the other warps wait at __syncthreads, taking no
//       issue slots from the warps still finishing step t - 1;
//     - the product h_{t-1} R over 16 warps (2 column groups x 8 k slices
//       at hd = 512, U = 32) on the tensor cores (mma.m16n8k16): h_{t-1}
//       is split into three bf16 pieces, hi + mid + lo = h exactly,
//       written once as A fragments (row 4 p + r: piece p, batch row r);
//       R's slice is stored as B fragments, so a warp reads each operand
//       with one 8- or 16-byte load a lane;
//     - the k slices' partial sums meet in shared memory; one
//       __syncthreads; a thread per (row, unit) adds the
//       unit's 4 gates (one float4 a slice) in slice order, adds xpre
//       (loaded at the top of the step, before the wait) and finishes the
//       gates, its (c, n, m) kept in shared memory;
//     - the four threads of a unit gather its 4 rows of h_t into a float4
//       and st.async it into slot t & 1 of every CTA of the cluster, each
//       store counting 16 bytes on that CTA's slot mbarrier.  Nothing on
//       the chain waits for L2 or device memory, and nothing releases at
//       cluster scope: a barrier.cluster arrive would wait for the h_out
//       store and the xpre load first.
//    The partial sums and the A fragments have one buffer: step t writes
//    them only after its first __syncthreads, which every thread reaches
//    after its last read of step t - 1's.
//    Double buffer: step t reads slot (t - 1) & 1 and stores into slot
//    t & 1 of every peer.  A CTA stores h_{t+1} into a peer's slot
//    (t + 1) & 1 = (t - 1) & 1 only after its own wait for h_t returned,
//    which needs the peer's h_t; the peer stored h_t after its
//    __syncthreads that follows its product of step t, its last read of
//    h_{t-1}, so the slot is free.  A slot's mbarrier is armed (one
//    arrival plus the slot's bytes) for its next phase right after the
//    wait of its current one, before any peer can store the next phase's
//    bytes.  A cluster barrier before the first step makes every CTA's
//    barriers and buffers initialised (and every CTA running) before any
//    peer stores into them, and one after the last step keeps every CTA
//    alive until no store can be in flight.
//    Heads (and batch groups) are independent clusters, so they need not
//    be co-resident: H = 16 runs in waves.  Batch rows come in chunks of
//    4 (a float4 of h, 12 of the 16 rows of an A fragment); G = ceil(B /
//    rows) clusters a head when the chunks' buffers would not fit beside
//    R.  The tensor cores' product is the largest part of a step (each
//    mma.m16n8k16 carries 12 useful rows of 16), then the finishing
//    thread's chain (partial sums, gates, stores); a wgmma form (h's
//    pieces as B, N = 16, R from shared memory or registers) was right
//    but slower and is not kept.
//
// 3. cooperative (S >= 2, f32 R; a head's f32 R at hd = 512, 4 MB, fits
//    no 16-CTA cluster).  Each head's units over P co-resident CTAs of
//    16 units (a cooperative launch, refused when the grid cannot be
//    resident), R's columns held in f32 shared memory, h_t exchanged
//    through a double buffer in device memory, and a release/acquire
//    arrival counter per head (thread 0 spins with ld.acquire.gpu).  A
//    CTA writes h_{t+1} over h_{t-1} only after all P CTAs published h_t,
//    which each does after its last read of h_{t-1}.
//
// No atomics touch the arithmetic and every sum has a fixed order, so every
// run gives the same bits on every route.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_ptx.cuh"

namespace {

constexpr int kMaxSharedBytes = 232448;   // 227 KB a block may use on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// log(sigmoid(x)) = -softplus(-x), softplus in JAX's logaddexp form
__device__ __forceinline__ float logsig(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// one unit's gates from tot = xpre + h_{t-1} R (z, i, f, o); updates
// (c, n, m) and returns h_t
__device__ __forceinline__ float cell(const float (&tot)[4], float& c,
                                      float& n, float& m) {
  const float z = tanhf(tot[0]);
  const float logi = tot[1];
  const float logf = logsig(tot[2]);
  const float o = 1.f / (1.f + expf(-tot[3]));
  const float m_new = fmaxf(logf + m, logi);
  const float i_s = expf(logi - m_new);
  const float f_s = expf(logf + m - m_new);
  c = f_s * c + i_s * z;
  n = f_s * n + i_s;
  m = m_new;
  return o * c / fmaxf(n, 1e-6f);
}

// lanes l and l ^ mask each keep half of v[0, N) and add the partner's
// copy of that half: the lane with (l & mask) == 0 keeps v[0, N/2), the
// other v[N/2, N); both end with their half's sum in v[0, N/2)
template <int N, int M>
__device__ __forceinline__ void reduce_half(float (&v)[M], int lane,
                                            int mask) {
  const bool upper = (lane & mask) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? v[i] : v[i + N / 2];
    const float keep = upper ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

struct Args {
  const void* xpre;
  const void* r;
  const float* c0;
  const float* n0;
  const float* h0;
  const float* m0;
  void* out;
  float* c1;
  float* n1;
  float* h1;
  float* m1;
  int B, S, H, hd;
  long long xs_b, xs_s, xs_g, xs_h;
};

// ===========================================================================
// 1. step route (S = 1)
// ===========================================================================

constexpr int kStepThreads = 256;              // 8 warps
constexpr int kStepSlices = kStepThreads / 8;  // k rows a pass
constexpr int kStepBatch = 16;                 // R loads in flight a thread

// 16 bytes of R as VE floats
template <typename TR, int VE>
__device__ __forceinline__ void unpack_r(float (&r)[VE], const uint4& w) {
  if constexpr (sizeof(TR) == 2) {
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < VE / 2; ++e) {
      const float2 f = __bfloat1622float2(q[e]);
      r[2 * e] = f.x;
      r[2 * e + 1] = f.y;
    }
  } else {
    const float* q = reinterpret_cast<const float*>(&w);
#pragma unroll
    for (int e = 0; e < VE; ++e) r[e] = q[e];
  }
}

// VE elements of R from p: one 16-byte load where the block is in range
// and aligned, else the first n_ok elements one at a time (the rest zero)
template <typename TR, int VE>
__device__ __forceinline__ uint4 load_r(const TR* p, bool vec, int n_ok) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  TR* q = reinterpret_cast<TR*>(&w);
#pragma unroll
  for (int e = 0; e < VE; ++e)
    if (e < n_ok) q[e] = p[e];
  return w;
}

template <typename TX, typename TR>
__global__ void __launch_bounds__(kStepThreads) slstm_step_kernel(
    const Args a) {
  constexpr int VE = 16 / sizeof(TR);   // elements of one 16-byte load
  constexpr int UC = 2 * VE;            // units a CTA: 32 bytes a gate row
  __shared__ float red[kStepThreads / 32][4][4][UC];  // [warp][row][gate][u]
  extern __shared__ float hs[];                       // [4][hd]: rows of h0
  const int hd = a.hd, B = a.B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // lane = 8 kq + 2 g + half: k row 4 warp + kq of each pass, gate g,
  // units [u0 + half VE, u0 + half VE + VE)
  const int g = (lane >> 1) & 3, half = lane & 1, kq = lane >> 3;
  const int kk = warp * 4 + kq;
  const int head = blockIdx.y, u0 = blockIdx.x * UC, ub = u0 + half * VE;
  const long long bh = (long long)a.H * hd, head_hd = (long long)head * hd;
  const TR* rcol = static_cast<const TR*>(a.r) + head_hd * 4 * hd +
                   (long long)g * hd + ub;
  const bool vec = (hd * sizeof(TR)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.r) % 16 == 0 && ub + VE <= hd;
  const int n_ok = hd - ub;
  const int n_k = kk < hd ? (hd - kk + kStepSlices - 1) / kStepSlices : 0;
  const TX* x = static_cast<const TX*>(a.xpre);
  TX* out = static_cast<TX*>(a.out);
  // finishing threads: (row fr, unit fu) of the chunk
  const bool fin = tid < 4 * UC;
  const int fr = tid / UC, fu = tid - fr * UC, funit = u0 + fu;

  for (int b0 = 0; b0 < B; b0 += 4) {
    // the finishing threads' inputs, issued first (off the chain)
    const int fb = b0 + fr;
    const bool fok = fin && fb < B && funit < hd;
    const long long fi = fb * bh + head_hd + funit;
    TX xg[4];
    float c = 0.f, n = 0.f, m = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) from_f(&xg[q], 0.f);
    if (fok) {
      const TX* xp = x + fb * a.xs_b + head * a.xs_h + funit;
#pragma unroll
      for (int q = 0; q < 4; ++q) xg[q] = xp[q * a.xs_g];
      c = a.c0[fi];
      n = a.n0[fi];
      m = a.m0[fi];
    }
    float acc[4 * VE];
#pragma unroll
    for (int i = 0; i < 4 * VE; ++i) acc[i] = 0.f;
    // the CTA's k rows in batches: every load of a batch is issued before
    // any is used; h0's rows are staged while the first batch is in flight
    for (int i0 = 0; i0 == 0 || i0 < n_k; i0 += kStepBatch) {
      uint4 w[kStepBatch];
#pragma unroll
      for (int i = 0; i < kStepBatch; ++i)
        if (i0 + i < n_k)
          w[i] = load_r<TR, VE>(
              rcol + (long long)(kk + (i0 + i) * kStepSlices) * 4 * hd, vec,
              n_ok);
      if (i0 == 0) {
        for (int e = tid; e < 4 * hd; e += kStepThreads) {
          const int row = e / hd, k = e - row * hd;
          hs[e] = b0 + row < B ? a.h0[(b0 + row) * bh + head_hd + k] : 0.f;
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kStepBatch; ++i) {
        if (i0 + i < n_k) {
          const int k = kk + (i0 + i) * kStepSlices;
          float r[VE];
          unpack_r<TR, VE>(r, w[i]);
#pragma unroll
          for (int row = 0; row < 4; ++row) {
            const float hv = hs[row * hd + k];
#pragma unroll
            for (int e = 0; e < VE; ++e)
              acc[row * VE + e] = fmaf(hv, r[e], acc[row * VE + e]);
          }
        }
      }
    }
    // sum the warp's 4 k rows: the lane with kq = 2 b3 + b4 (bits 3 and 4
    // of the lane) ends with row 2 b3 + b4 in acc[0, VE)
    reduce_half<4 * VE>(acc, lane, 8);
    reduce_half<2 * VE>(acc, lane, 16);
    const int row = ((lane >> 3) & 1) * 2 + (lane >> 4);
#pragma unroll
    for (int e = 0; e < VE; ++e) red[warp][row][g][half * VE + e] = acc[e];
    __syncthreads();
    if (fok) {
      float tot[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kStepThreads / 32; ++w) s += red[w][fr][q][fu];
        tot[q] = to_f(xg[q]) + s;
      }
      const float h = cell(tot, c, n, m);
      from_f(out + fi, h);
      a.c1[fi] = c;
      a.n1[fi] = n;
      a.h1[fi] = h;
      a.m1[fi] = m;
    }
    __syncthreads();   // red and hs are reused by the next chunk of rows
  }
}

// dynamic shared memory of the step kernel: 4 rows of h0
size_t step_smem(int hd) { return sizeof(float) * 4 * (size_t)hd; }

template <typename TX, typename TR>
int launch_step(const Args& a, cudaStream_t stream) {
  constexpr int UC = 32 / sizeof(TR);
  const void* kern = (const void*)slstm_step_kernel<TX, TR>;
  // the attribute: once per process and instance
  static const cudaError_t configured = [kern] {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kern);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSharedBytes - (int)attr.sharedSizeBytes);
    if (e != cudaSuccess) cudaGetLastError();
    return e;
  }();
  if (configured != cudaSuccess) return (int)configured;
  const size_t smem = step_smem(a.hd);
  if (smem + sizeof(float) * 4 * 4 * UC * (kStepThreads / 32) >
      (size_t)kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.hd + UC - 1) / UC), (unsigned)a.H);
  slstm_step_kernel<TX, TR><<<grid, kStepThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ===========================================================================
// 2. cluster route (S >= 2)
// ===========================================================================

constexpr int kClusterThreads = 512;   // 16 warps
constexpr int kMaxFinish = 2;          // (row, unit) items a thread finishes

// the CTA's layout, computed alike on the host and the device (and by
// cluster_smem in ops.py)
struct ClusterShape {
  int Up;   // units, rounded up to pairs
  int C;    // gate columns 4 Up, unit-major: 4 lu + g
  int NG;   // column groups of 64 (8 n-tiles; a power of two <= 16)
  int KS;   // k slices: 16 / NG
  int NC;   // chunks of 4 batch rows
  int CS;   // row stride of the partial sums, C + 8 (no bank conflicts)
  int KT;   // k tiles of 16 (the tensor-core product)
};

__host__ __device__ __forceinline__ ClusterShape cluster_shape(int hd, int U,
                                                               int rows) {
  ClusterShape s;
  s.Up = U + (U & 1);
  s.C = 4 * s.Up;
  const int groups = (s.C + 63) / 64;
  s.NG = 1;
  while (s.NG < groups) s.NG *= 2;
  s.KS = s.NG <= 16 ? 16 / s.NG : 0;
  s.NC = (rows + 3) / 4;
  s.CS = s.C + 8;
  s.KT = (hd + 15) / 16;
  return s;
}

// the two h slots' barriers (16 bytes), R's slice in bf16 as B fragments
// [C' / 8][KT][32 lanes][4], C' = C rounded up to 64, zero past hd and C;
// the h slots [2][NC][hd] float4; h_{t-1} in three pieces as A fragments
// [NC][KT][32 lanes] uint4; the partial sums [NC][KS][4][CS] and the state
// c, n, m [4 NC][Up] in f32
size_t cluster_smem(int hd, int U, int rows) {
  const ClusterShape s = cluster_shape(hd, U, rows);
  return 16 + (size_t)s.KT * 16 * ((s.C + 63) / 64 * 64) * 2 +
         2 * (size_t)s.NC * hd * 16 + (size_t)s.NC * s.KT * 512 +
         (size_t)s.NC * s.KS * 4 * s.CS * 4 +
         3 * (size_t)s.NC * 4 * s.Up * 4;
}

__device__ __forceinline__ float comp(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// x = hi + mid + lo in bf16, exactly for an f32 x (8 + 8 + 8 bits)
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the whole cluster: every thread of every CTA
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   mlego::smem_addr(bar))
               : "memory");
}
// the one arrival of the barrier's next phase, which then also waits for
// `bytes` bytes of st.async
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n" ::
          "r"(mlego::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// until the phase of parity `parity` has completed, which makes the
// st.async bytes it counted visible to the waiting thread
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(mlego::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// v into the float4 at `local` in cluster CTA `rank`'s shared memory; the
// 16 bytes count towards that CTA's barrier at `bar`
__device__ __forceinline__ void st_async(const void* local, const void* bar,
                                         unsigned rank, float4 v) {
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(dst)
               : "r"(mlego::smem_addr(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(mlego::smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rbar)
      : "memory");
}

struct ClusterArgs {
  Args a;
  int U;      // units a CTA (the last CTA of a head may hold fewer)
  int rows;   // batch rows a cluster
};

template <typename TX>
__global__ void __launch_bounds__(kClusterThreads, 1)
    slstm_cluster_kernel(const ClusterArgs ca) {
  using TR = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  const Args& a = ca.a;
  const int U = ca.U, rows = ca.rows, hd = a.hd, B = a.B, S = a.S;
  const ClusterShape sh = cluster_shape(hd, U, rows);
  const int Up = sh.Up, C = sh.C, NC = sh.NC, KS = sh.KS, CS = sh.CS;
  const int KT = sh.KT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);   // [2]: h slots
  TR* Rs = reinterpret_cast<TR*>(smem4 + 1);
  const int cr = (C + 63) / 64 * 64;   // columns of the slice, zero past C
  float4* Hs = reinterpret_cast<float4*>(Rs + (size_t)KT * 16 * cr);
                                                            // [2][NC][hd]
  uint32_t* Af = reinterpret_cast<uint32_t*>(Hs + 2 * (size_t)NC * hd);
  float* red = reinterpret_cast<float*>(Af + (size_t)NC * KT * 32 * 4);
                                                      // [NC][KS][4][CS]
  float* st_c = red + (size_t)NC * KS * 4 * CS;            // [NC 4][Up]
  float* st_n = st_c + NC * 4 * Up;
  float* st_m = st_n + NC * 4 * Up;

  const unsigned P = gridDim.x;        // the cluster spans x: rank = x
  const int rank = blockIdx.x, head = blockIdx.y;
  const int bg = blockIdx.z * rows;    // first batch row of this cluster
  const int u0 = rank * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = (long long)a.H * hd, head_hd = (long long)head * hd;
  const TX* x = static_cast<const TX*>(a.xpre);
  TX* out = static_cast<TX*>(a.out);

  // R's column g hd + u0 + lu as column c = 4 lu + g of the slice (zero
  // past the units and past hd), read in R's order and stored in the
  // B-fragment order of mma.m16n8k16 (lane 4 n + q holds rows 2q, 2q + 1,
  // 2q + 8, 2q + 9 of n-tile column n)
  const TR* rh = static_cast<const TR*>(a.r) + head_hd * 4 * hd;
  for (int e = tid; e < KT * 16 * cr; e += kClusterThreads) {
    const int k = e / cr, o = e - k * cr, g = o / Up, lu = o - g * Up;
    const int c = o < C ? 4 * lu + g : o, kk = k & 15;
    TR v = __float2bfloat16(0.f);
    if (k < hd && o < C && lu < U && u0 + lu < hd)
      v = rh[(long long)k * 4 * hd + g * hd + u0 + lu];
    Rs[(((c >> 3) * KT + (k >> 4)) * 32 + (c & 7) * 4 + ((kk & 7) >> 1)) * 4 +
       (kk >> 3) * 2 + (kk & 1)] = v;
  }
  // slot 1 holds h_{-1} = h0; slot 0 is zero until the peers store h_0
  for (int e = tid; e < NC * hd; e += kClusterThreads) {
    const int ch = e / hd, k = e - ch * hd;
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int b = bg + ch * 4 + r;
      v[r] = ch * 4 + r < rows && b < B ? a.h0[b * bh + head_hd + k] : 0.f;
    }
    Hs[(size_t)(NC + ch) * hd + k] = make_float4(v[0], v[1], v[2], v[3]);
    Hs[(size_t)ch * hd + k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // rows 12..15 of the A fragments (a fourth piece) stay zero
  for (int e = tid; e < NC * KT * 32 * 4; e += kClusterThreads) Af[e] = 0u;
  for (int e = tid; e < NC * 4 * Up; e += kClusterThreads) {
    const int row = e / Up, lu = e - row * Up, b = bg + row, unit = u0 + lu;
    const bool ok = row < rows && b < B && lu < U && unit < hd;
    const long long i = b * bh + head_hd + unit;
    st_c[e] = ok ? a.c0[i] : 0.f;
    st_n[e] = ok ? a.n0[i] : 0.f;
    st_m[e] = ok ? a.m0[i] : 0.f;
  }

  // finishing: item f = tid + it 512 is (chunk, unit lu, row r), r fastest
  const int NF = NC * 4 * Up;
  // xpre of each item's step, raw: a predicated load issued at the top of
  // the step, before the wait, with nothing waiting for the value until
  // the gates use it (the wait and the product cover its latency)
  TX xn[kMaxFinish][4];
  auto load_x = [&](int it, int t) {
    const int f = tid + it * kClusterThreads;
    const int r = f & 3, lu = (f >> 2) % Up, ch = (f >> 2) / Up;
    const int b = bg + ch * 4 + r, unit = u0 + lu;
    const bool ok =
        t < S && f < NF && ch * 4 + r < rows && b < B && lu < U && unit < hd;
    const TX* xp = x + b * a.xs_b + t * a.xs_s + head * a.xs_h + unit;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (ok) xn[it][q] = xp[q * a.xs_g];
  };
#pragma unroll
  for (int it = 0; it < kMaxFinish; ++it)
#pragma unroll
    for (int q = 0; q < 4; ++q) from_f(&xn[it][q], 0.f);
  // slot j's barrier completes a phase when all of h_t (t = j, j + 2, ...)
  // has arrived: hd x NC float4 from the P CTAs
  const unsigned slot_bytes = (unsigned)(hd * NC * 16);
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    if (S > 1) mbar_arm(&bars[0], slot_bytes);   // h_0
    if (S > 2) mbar_arm(&bars[1], slot_bytes);   // h_1
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA initialised (and running) before any peer stores into it
  cluster_sync();

  // product: warp (cg, ks) takes n-tiles 8 cg .. 8 cg + 7 over k slice ks
  const int cg = warp % sh.NG, ks = warp / sh.NG;
  const int NTp = cr / 8, nt0 = cg * 8;   // n-tiles, padded
  const int ktl = (KT + KS - 1) / KS;
  const int kt_lo = ks * ktl, kt_hi = min(KT, kt_lo + ktl);

  for (int t = 0; t < S; ++t) {
#pragma unroll
    for (int it = 0; it < kMaxFinish; ++it)
      if ((tid & ~31) + it * kClusterThreads < NF) load_x(it, t);
    if (t > 0) {
      // h_{t-1}: phase (t - 1) / 2 of slot (t - 1) & 1.  One warp polls;
      // the others wait at the CTA barrier, where they take no issue
      // slots from the warps still finishing step t - 1
      const int j = (t - 1) & 1;
      if (warp == 0) mbar_wait(&bars[j], ((t - 1) >> 1) & 1);
      __syncthreads();
      // the slot's next phase carries h_{t+1}, sent in step t + 1
      if (tid == 0 && t + 2 < S) mbar_arm(&bars[j], slot_bytes);
    }
    const float4* hb = Hs + (size_t)((t - 1) & 1) * NC * hd;
    // h_{t-1} in three bf16 pieces as the A operand: row m = 4 p + r
    // (piece p, batch row r of the chunk), rows 12..15 zero
    for (int e = tid; e < NC * KT * 8; e += kClusterThreads) {
      const int ch = e / (KT * 8), k0 = 2 * (e - ch * KT * 8);
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 v0 = k0 < hd ? hb[(size_t)ch * hd + k0] : z4;
      const float4 v1 = k0 + 1 < hd ? hb[(size_t)ch * hd + k0 + 1] : z4;
      const int kk = k0 & 15, q = (kk & 7) >> 1, jb = (kk >> 3) * 2;
      uint32_t* af = Af + ((size_t)(ch * KT + (k0 >> 4)) * 32 + q) * 4 + jb;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        __nv_bfloat16 p0[3], p1[3];
        split3(comp(v0, r), p0);
        split3(comp(v1, r), p1);
        af[r * 16] = pack2(p0[0], p1[0]);           // row r: lane 4 r + q
        af[(4 + r) * 16] = pack2(p0[1], p1[1]);     // row 4 + r
        af[r * 16 + 1] = pack2(p0[2], p1[2]);       // row 8 + r
      }
    }
    __syncthreads();
    const uint2* Rf = reinterpret_cast<const uint2*>(Rs);
    const uint4* Af4 = reinterpret_cast<const uint4*>(Af);
    for (int ch = 0; ch < NC && nt0 < NTp; ++ch) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const uint4* ap = Af4 + (size_t)ch * KT * 32 + lane;
      const uint2* bp = Rf + (size_t)nt0 * KT * 32 + lane;   // n-tile: KT 32
      uint4 av = make_uint4(0u, 0u, 0u, 0u);
      uint2 bv[8];
      if (kt_lo < kt_hi) {
        av = ap[kt_lo * 32];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bp[((size_t)j * KT + kt_lo) * 32];
      }
      for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const uint32_t af[4] = {av.x, av.y, av.z, av.w};
        uint2 bc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) bc[j] = bv[j];
        if (kt + 1 < kt_hi) {
          av = ap[(kt + 1) * 32];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            bv[j] = bp[((size_t)j * KT + kt + 1) * 32];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) mlego::mma_bf16(acc[j], af, bc[j].x, bc[j].y);
      }
      // row r = lane / 4 < 4: pieces 0 and 2 here, piece 1 in lane + 16
      float* out_red = red + (size_t)((ch * KS + ks) * 4 + (lane >> 2)) * CS +
                       2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p1a = __shfl_xor_sync(0xffffffffu, acc[j][0], 16);
        const float p1b = __shfl_xor_sync(0xffffffffu, acc[j][1], 16);
        if (lane < 16 && (nt0 + j) * 8 < C)
          *reinterpret_cast<float2*>(out_red + (nt0 + j) * 8) =
              make_float2(acc[j][0] + acc[j][2] + p1a,
                          acc[j][1] + acc[j][3] + p1b);
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kMaxFinish; ++it) {
      if ((tid & ~31) + it * kClusterThreads >= NF) break;   // warp-uniform
      const int f = tid + it * kClusterThreads;
      const int r = f & 3, lu = (f >> 2) % Up, ch = (f >> 2) / Up;
      const int row = ch * 4 + r, b = bg + row, unit = u0 + lu;
      const bool own = f < NF && lu < U && unit < hd;
      const bool ok = own && row < rows && b < B;
      float h = 0.f;
      if (ok) {
        // the k slices' partial sums of the unit's 4 gates (one float4 a
        // slice), in slice order: every load issued before the first add
        const float4* p = reinterpret_cast<const float4*>(
            red + (size_t)(ch * KS * 4 + r) * CS + 4 * lu);
        float4 v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j < KS) v[j] = p[(size_t)j * CS];
        }
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (j < KS) s[q] += comp(v[j], q);
        float tot[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[q] = to_f(xn[it][q]) + s[q];
        const int si = row * Up + lu;
        float c = st_c[si], n = st_n[si], m = st_m[si];
        h = cell(tot, c, n, m);
        st_c[si] = c;
        st_n[si] = n;
        st_m[si] = m;
        from_f(out + ((long long)b * S + t) * bh + head_hd + unit, h);
        if (t + 1 == S) {
          const long long i = b * bh + head_hd + unit;
          a.c1[i] = c;
          a.n1[i] = n;
          a.h1[i] = h;
          a.m1[i] = m;
        }
      }
      if (t + 1 < S) {
        // the unit's 4 rows of h_t, from the 4 lanes of its quad, into
        // slot t & 1 of every CTA of the cluster (lane r: ranks r + 4j),
        // each store completing 16 bytes of that CTA's slot barrier
        const float4 hv = make_float4(__shfl_sync(0xffffffffu, h, 0, 4),
                                      __shfl_sync(0xffffffffu, h, 1, 4),
                                      __shfl_sync(0xffffffffu, h, 2, 4),
                                      __shfl_sync(0xffffffffu, h, 3, 4));
        if (own) {
          const float4* dst = Hs + (size_t)((t & 1) * NC + ch) * hd + unit;
          for (unsigned p = r; p < P; p += 4)
            st_async(dst, &bars[t & 1], p, hv);
        }
      }
    }
  }
  cluster_sync();   // no CTA exits while a store may still be in flight
}

template <typename TX>
cudaError_t configure_cluster() {
  const void* kern = (const void*)slstm_cluster_kernel<TX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// the launch configuration of a cluster call (shared by the launch and the
// occupancy query); the attribute array must outlive `cfg`
template <typename TX>
int cluster_config(const ClusterArgs& ca, int P, long long smem,
                   cudaStream_t stream, cudaLaunchConfig_t* cfg,
                   cudaLaunchAttribute* attr) {
  // set once per process and instance (a function-local static)
  static const cudaError_t configured = configure_cluster<TX>();
  if (configured != cudaSuccess) return (int)configured;
  const ClusterShape sh = cluster_shape(ca.a.hd, ca.U, ca.rows);
  if (P < 1 || P > 16 || (P & (P - 1)) != 0 || ca.U < 1 ||
      (long long)P * ca.U < ca.a.hd || ca.rows < 1 || sh.KS < 1 ||
      sh.NC * 4 * sh.Up > kMaxFinish * kClusterThreads ||
      smem != (long long)cluster_smem(ca.a.hd, ca.U, ca.rows) ||
      smem > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  const unsigned groups = (unsigned)((ca.a.B + ca.rows - 1) / ca.rows);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)P, (unsigned)ca.a.H, groups);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <typename TX>
int launch_cluster(const ClusterArgs& ca, int P, long long smem,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int status = cluster_config<TX>(ca, P, smem, stream, &cfg, attr);
  if (status != 0) return status;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, slstm_cluster_kernel<TX>,
                                             ca);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename TX>
int cluster_occupancy(const ClusterArgs& ca, int P, long long smem,
                      int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int status = cluster_config<TX>(ca, P, smem, 0, &cfg, attr);
  if (status != 0) return status;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      clusters, (const void*)slstm_cluster_kernel<TX>, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// ===========================================================================
// 3. cooperative route (S >= 2, f32 R that no cluster holds)
// ===========================================================================

constexpr int kThreads = 256;
constexpr int kBC = 4;                    // batch rows per pass: one float4

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

struct CoopArgs {
  Args a;
  float* hbuf;        // (2, B, H, hd) f32: h_t of every head, double buffer
  unsigned* arrive;   // (H,) arrivals per head, zero at launch
  int U;
};

size_t coop_smem(int hd, int U, int B) {
  // R columns [hd][4U], h rows [hd] float4, partial sums [K][kBC][4U]
  // (= kThreads * kBC floats), state c, n, m [B][U]
  return sizeof(float) * ((size_t)hd * 4 * U + (size_t)hd * kBC +
                          (size_t)kThreads * kBC + 3 * (size_t)B * U);
}

template <typename TX, typename TR>
__global__ void __launch_bounds__(kThreads) slstm_coop_kernel(
    const CoopArgs ca) {
  extern __shared__ float4 smem4[];
  const Args& a = ca.a;
  const int U = ca.U, C = 4 * U, K = kThreads / C;
  const int B = a.B, S = a.S, H = a.H, hd = a.hd;
  float* Rs = reinterpret_cast<float*>(smem4);            // [hd][C]
  float4* Hs = reinterpret_cast<float4*>(Rs + (size_t)hd * C);  // [hd]
  float* Red = reinterpret_cast<float*>(Hs + hd);         // [K][kBC][C]
  float* Cs = Red + kThreads * kBC;                       // [B][U]
  float* Ns = Cs + B * U;
  float* Ms = Ns + B * U;

  const int head = blockIdx.y;
  const int u0 = blockIdx.x * U;
  const unsigned P = gridDim.x;
  const int tid = threadIdx.x;
  const int col = tid % C, part = tid / C;
  const TX* x = static_cast<const TX*>(a.xpre);
  TX* out = static_cast<TX*>(a.out);
  const long long head_hd = (long long)head * hd;
  const long long bh = (long long)H * hd;                 // one batch row

  // this CTA's columns of R, and the state of its units
  const TR* rh = static_cast<const TR*>(a.r) + head_hd * 4 * hd;
  for (int e = tid; e < hd * C; e += kThreads) {
    const int d = e / C, c = e - d * C;
    const int g = c / U, unit = u0 + c - g * U;
    Rs[e] = unit < hd ? to_f(rh[(long long)d * 4 * hd + g * hd + unit]) : 0.f;
  }
  for (int e = tid; e < B * U; e += kThreads) {
    const int b = e / U, unit = u0 + e - b * U;
    if (unit < hd) {
      const long long i = b * bh + head_hd + unit;
      Cs[e] = a.c0[i];
      Ns[e] = a.n0[i];
      Ms[e] = a.m0[i];
    }
  }

  // threads tid < kBC * U finish the gates of (row b0 + fbb, unit funit)
  const bool fin = tid < kBC * U;
  const int fbb = tid / U;
  const int fu = tid - fbb * U;
  const int funit = u0 + fu;
  float xn[4] = {0.f, 0.f, 0.f, 0.f};     // xpre of the next (t, row)
  auto load_x = [&](int t, int b) {
    if (fin && funit < hd && b < B && t < S) {
      const TX* xp = x + b * a.xs_b + t * a.xs_s + head * a.xs_h + funit;
#pragma unroll
      for (int g = 0; g < 4; ++g) xn[g] = to_f(xp[g * a.xs_g]);
    }
  };
  load_x(0, fbb);

  const int n_chunks = (B + kBC - 1) / kBC;
  for (int t = 0; t < S; ++t) {
    const float* hsrc = a.h0;
    if (t > 0) {
      // wait until all P CTAs of this head have published h_{t-1}
      if (tid == 0) {
        const unsigned target = P * (unsigned)t;
        while (ld_acquire(ca.arrive + head) < target) {
        }
        __threadfence();
      }
      __syncthreads();
      hsrc = ca.hbuf + (size_t)((t - 1) & 1) * B * bh;
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int b0 = ch * kBC;
      for (int d = tid; d < hd; d += kThreads) {
        float v[kBC];
#pragma unroll
        for (int bb = 0; bb < kBC; ++bb)
          v[bb] = b0 + bb < B ? __ldcg(hsrc + (b0 + bb) * bh + head_hd + d)
                              : 0.f;
        Hs[d] = make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll 4
      for (int d = part; d < hd; d += K) {
        const float r = Rs[d * C + col];
        const float4 hv = Hs[d];
        acc0 = fmaf(hv.x, r, acc0);
        acc1 = fmaf(hv.y, r, acc1);
        acc2 = fmaf(hv.z, r, acc2);
        acc3 = fmaf(hv.w, r, acc3);
      }
      float* red = Red + part * kBC * C + col;
      red[0] = acc0;
      red[C] = acc1;
      red[2 * C] = acc2;
      red[3 * C] = acc3;
      __syncthreads();
      if (fin) {
        const int b = b0 + fbb;
        if (b < B && funit < hd) {
          float tot[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float s = 0.f;
            for (int k = 0; k < K; ++k) s += Red[(k * kBC + fbb) * C + g * U + fu];
            tot[g] = xn[g] + s;
          }
          const int si = b * U + fu;
          float c = Cs[si], n = Ns[si], m = Ms[si];
          const float h = cell(tot, c, n, m);
          Cs[si] = c;
          Ns[si] = n;
          Ms[si] = m;
          const long long hi = b * bh + head_hd + funit;
          from_f(out + ((long long)b * S + t) * bh + head_hd + funit, h);
          if (t + 1 < S) {
            ca.hbuf[(size_t)(t & 1) * B * bh + hi] = h;
          } else {
            a.c1[hi] = c;
            a.n1[hi] = n;
            a.h1[hi] = h;
            a.m1[hi] = m;
          }
        }
        if (ch + 1 < n_chunks)
          load_x(t, b0 + kBC + fbb);
        else
          load_x(t + 1, fbb);
      }
      __syncthreads();   // Hs and Red are reused; orders this step's writes
    }
    if (t + 1 < S && tid == 0) {
      __threadfence();
      add_release(ca.arrive + head, 1u);
    }
  }
}

struct CoopDevice {
  cudaError_t err;
  int sms, coop;
};

CoopDevice coop_device() {
  CoopDevice d{cudaSuccess, 0, 0};
  int dev = 0;
  d.err = cudaGetDevice(&dev);
  if (d.err == cudaSuccess)
    d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (d.err == cudaSuccess)
    d.err = cudaDeviceGetAttribute(&d.coop, cudaDevAttrCooperativeLaunch, dev);
  if (d.err != cudaSuccess) cudaGetLastError();
  return d;
}

template <typename TX, typename TR>
int launch_coop(const CoopArgs& ca, cudaStream_t stream) {
  const void* kern = (const void*)slstm_coop_kernel<TX, TR>;
  // the attribute and the card's properties: once per process
  static const cudaError_t configured = [kern] {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (e != cudaSuccess) cudaGetLastError();
    return e;
  }();
  static const CoopDevice card = coop_device();
  if (configured != cudaSuccess) return (int)configured;
  if (card.err != cudaSuccess) return (int)card.err;
  if (!card.coop) return (int)cudaErrorNotSupported;
  const Args& a = ca.a;
  const size_t bytes = coop_smem(a.hd, ca.U, a.B);
  if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, kThreads, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const int P = (a.hd + ca.U - 1) / ca.U;
  // every CTA of the grid must be resident at once, or the wait deadlocks
  if ((long long)per_sm * card.sms < (long long)P * a.H)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  CoopArgs args = ca;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kern, dim3((unsigned)P, (unsigned)a.H),
                                    dim3(kThreads), params, bytes, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

bool valid(const Args& a) {
  return a.B >= 1 && a.S >= 1 && a.H >= 1 && a.hd >= 1;
}

// calls fn<TX, TR>() for the dtype codes (0 = float32, 1 = bfloat16)
template <template <typename, typename> class F, typename... Ts>
int dispatch(int x_dtype, int r_dtype, Ts&&... args) {
  if (x_dtype == 0 && r_dtype == 0) return F<float, float>::run(args...);
  if (x_dtype == 0 && r_dtype == 1)
    return F<float, __nv_bfloat16>::run(args...);
  if (x_dtype == 1 && r_dtype == 0)
    return F<__nv_bfloat16, float>::run(args...);
  if (x_dtype == 1 && r_dtype == 1)
    return F<__nv_bfloat16, __nv_bfloat16>::run(args...);
  return (int)cudaErrorInvalidValue;
}

template <typename TX, typename TR>
struct StepLaunch {
  static int run(const Args& a, cudaStream_t s) {
    return launch_step<TX, TR>(a, s);
  }
};
template <typename TX, typename TR>
struct CoopLaunch {
  static int run(const CoopArgs& ca, cudaStream_t s) {
    return launch_coop<TX, TR>(ca, s);
  }
};

}  // namespace

extern "C" {

// Common arguments: xpre, r_mat, c0, n0, h0, m0, out, c1, n1, h1, m1;
// x_dtype, r_dtype: 0 = float32, 1 = bfloat16; xpre strides (in elements)
// {b, s, gate, head}, the hd stride 1.

// S = 1: one step from (c0, n0, h0, m0).
int mlego_slstm_step(const void* xpre, const void* r_mat, const float* c0,
                     const float* n0, const float* h0, const float* m0,
                     void* out, float* c1, float* n1, float* h1, float* m1,
                     int x_dtype, int r_dtype, int B, int H, int hd,
                     long long xs_b, long long xs_g, long long xs_h,
                     void* stream) {
  const Args a{xpre, r_mat, c0, n0, h0, m0, out, c1, n1, h1, m1,
               B, 1, H, hd, xs_b, 0, xs_g, xs_h};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  return dispatch<StepLaunch>(x_dtype, r_dtype, a, (cudaStream_t)stream);
}

// bf16 R only.  One cluster of P CTAs (P a power of two <= 16) of `units`
// units per head and batch group of `rows` rows; smem_bytes must equal the
// kernel's own layout (scan_plan computes it alike).
int mlego_slstm_cluster(const void* xpre, const void* r_mat, const float* c0,
                        const float* n0, const float* h0, const float* m0,
                        void* out, float* c1, float* n1, float* h1, float* m1,
                        int x_dtype, int B, int S, int H, int hd, int P,
                        int units, int rows, long long smem_bytes,
                        long long xs_b, long long xs_s, long long xs_g,
                        long long xs_h, void* stream) {
  const ClusterArgs ca{{xpre, r_mat, c0, n0, h0, m0, out, c1, n1, h1, m1,
                        B, S, H, hd, xs_b, xs_s, xs_g, xs_h},
                       units, rows};
  if (!valid(ca.a)) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    return launch_cluster<float>(ca, P, smem_bytes, (cudaStream_t)stream);
  if (x_dtype == 1)
    return launch_cluster<__nv_bfloat16>(ca, P, smem_bytes,
                                         (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// cudaOccupancyMaxActiveClusters for the cluster launch of these arguments
// (sets the kernel's attributes first, as the launch does).
int mlego_slstm_cluster_occupancy(int x_dtype, int B, int H, int hd, int P,
                                  int units, int rows, long long smem_bytes,
                                  int* clusters) {
  const ClusterArgs ca{{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, nullptr, nullptr, B, 2, H,
                        hd, 0, 0, 0, 0},
                       units, rows};
  if (!valid(ca.a)) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0) return cluster_occupancy<float>(ca, P, smem_bytes, clusters);
  if (x_dtype == 1)
    return cluster_occupancy<__nv_bfloat16>(ca, P, smem_bytes, clusters);
  return (int)cudaErrorInvalidValue;
}

// The cooperative kernel: units (a power of two up to 64) per CTA,
// P = ceil(hd / units) co-resident CTAs per head.  hbuf is (2, B, H, hd)
// f32 scratch; arrive is (H,) unsigned and must be zero.
int mlego_slstm_coop(const void* xpre, const void* r_mat, const float* c0,
                     const float* n0, const float* h0, const float* m0,
                     void* out, float* c1, float* n1, float* h1, float* m1,
                     float* hbuf, unsigned* arrive, int x_dtype, int r_dtype,
                     int B, int S, int H, int hd, int units, long long xs_b,
                     long long xs_s, long long xs_g, long long xs_h,
                     void* stream) {
  const CoopArgs ca{{xpre, r_mat, c0, n0, h0, m0, out, c1, n1, h1, m1,
                     B, S, H, hd, xs_b, xs_s, xs_g, xs_h},
                    hbuf, arrive, units};
  if (!valid(ca.a) || units < 1 || units > 64 || (units & (units - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  return dispatch<CoopLaunch>(x_dtype, r_dtype, ca, (cudaStream_t)stream);
}

}  // extern "C"
