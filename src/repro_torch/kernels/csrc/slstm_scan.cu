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
// model's R is bf16-valued); state (c, n, h, m) (B, H, hd) f32.  Writes
// h_out (B, S, H, hd) in xpre's dtype and the final state in f32.  All
// arithmetic is f32.
//
// Replaces the Pallas kernel slstm_scan_pallas
// (src/repro/kernels/slstm_scan/slstm_scan.py:82), and with it the lax.scan
// _slstm_local_scan (src/repro/models/recurrent.py:177) that the JAX model
// runs in prefill and decode.
//
// Bound: latency.  Step t needs all of h_{t-1}, so a prefill of S tokens is
// a chain of S steps; a step's work (2 B hd 4hd flops, 67 MFLOP at B = 4,
// hd = 512, four heads) is tiny for the card, and its bytes are R, which
// must stay on chip.  One head's R at hd = 512 is 512 x 2,048 f32 = 4 MB;
// an SM gives a block at most 227 KB of shared memory.  The TPU kernel held
// one head's R in VMEM and walked the token chunks in grid order; on the GPU
// the whole sequence loop lives inside one launch and nothing depends on the
// order in which CTAs run.  The form chosen:
//  - each head's hd units are split over P co-resident CTAs (grid (P, H)),
//    U = hd / P units each (U a power of two, 16 at hd >= 16: P = 32 and
//    128 CTAs at hd = 512, H = 4, one wave on 132 SMs).  A CTA keeps the
//    four gate columns g hd + j of its units, hd x 4U f32 (128 KB at
//    U = 16), in shared memory for the whole launch, so R is read from
//    device memory once per call;
//  - every step each CTA reads the head's h_{t-1} (B x hd f32, from L2),
//    forms its 4U columns of h_{t-1} R for 4 batch rows at a time (256
//    threads: each owns one column and a 1/K slice of the reduction, the
//    slices summed in a fixed order through shared memory), finishes its
//    units' gates and (c, n, m, h), and writes its part of h_t to a double
//    buffer in device memory;
//  - the P CTAs of a head then wait for each other: thread 0 adds 1 to the
//    head's arrival counter with release order and spins with acquire
//    loads until it reaches P t (heads are independent, so the wait is per
//    head).  The double buffer lets a CTA write h_t while a slower CTA of
//    its head may still read h_{t-1}; h_{t+1} goes to the buffer of h_{t-1}
//    only after every CTA of the head has published h_t, which each does
//    after its last read of h_{t-1};
//  - a spin barrier on a grid that is not co-resident deadlocks, so the
//    launch is cooperative (cudaLaunchCooperativeKernel), after a check of
//    H P against cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SM
//    count; a grid that does not fit is refused with an error, never run;
//  - the next step's xpre values are loaded before the wait, off the chain.
// Alternatives not taken: bf16 R in one 16-CTA cluster exchanging h through
// distributed shared memory (the cluster size is non-portable and 16 CTAs
// hold 3.6 MB, so R would be rounded or split anyway), and R streamed from
// L2 every step by one CTA per head (4 MB through one SM a step, ~20-40 us).
// Making it fast (tensor cores on the B x hd x 4hd product, clusters) is
// later work.  No atomics touch the arithmetic and every sum has a fixed
// order, so every run gives the same bits.  The transcendental functions
// are the full-precision ones (no fast math).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBC = 4;                    // batch rows per pass: one float4
constexpr int kMaxSharedBytes = 232448;   // 227 KB a block may use on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// log(sigmoid(x)) = -softplus(-x), softplus in JAX's logaddexp form
__device__ __forceinline__ float logsig(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
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
  float* hbuf;        // (2, B, H, hd) f32: h_t of every head, double buffer
  unsigned* arrive;   // (H,) arrivals per head, zero at launch
  int B, S, H, hd, U;
  long long xs_b, xs_s, xs_g, xs_h;
};

size_t smem_bytes(int hd, int U, int B) {
  // R columns [hd][4U], h rows [hd] float4, partial sums [K][kBC][4U]
  // (= kThreads * kBC floats), state c, n, m [B][U]
  return sizeof(float) * ((size_t)hd * 4 * U + (size_t)hd * kBC +
                          (size_t)kThreads * kBC + 3 * (size_t)B * U);
}

template <typename TX, typename TR>
__global__ void __launch_bounds__(kThreads) slstm_scan_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int U = a.U, C = 4 * U, K = kThreads / C;
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
        while (ld_acquire(a.arrive + head) < target) {
        }
        __threadfence();
      }
      __syncthreads();
      hsrc = a.hbuf + (size_t)((t - 1) & 1) * B * bh;
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
          const float m = Ms[si];
          const float z = tanhf(tot[0]);
          const float logi = tot[1];
          const float logf = logsig(tot[2]);
          const float o = 1.f / (1.f + expf(-tot[3]));
          const float m_new = fmaxf(logf + m, logi);
          const float i_s = expf(logi - m_new);
          const float f_s = expf(logf + m - m_new);
          const float c = f_s * Cs[si] + i_s * z;
          const float n = f_s * Ns[si] + i_s;
          const float h = o * c / fmaxf(n, 1e-6f);
          Cs[si] = c;
          Ns[si] = n;
          Ms[si] = m_new;
          const long long hi = b * bh + head_hd + funit;
          from_f(out + ((long long)b * S + t) * bh + head_hd + funit, h);
          if (t + 1 < S) {
            a.hbuf[(size_t)(t & 1) * B * bh + hi] = h;
          } else {
            a.c1[hi] = c;
            a.n1[hi] = n;
            a.h1[hi] = h;
            a.m1[hi] = m_new;
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
      add_release(a.arrive + head, 1u);
    }
  }
}

template <typename TX, typename TR>
int launch(const Args& a, cudaStream_t stream) {
  const void* kern = (const void*)slstm_scan_kernel<TX, TR>;
  const size_t bytes = smem_bytes(a.hd, a.U, a.B);
  if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if (!coop) return (int)cudaErrorNotSupported;
  const int P = (a.hd + a.U - 1) / a.U;
  // every CTA of the grid must be resident at once, or the wait deadlocks
  if ((long long)per_sm * sms < (long long)P * a.H)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  Args args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kern, dim3((unsigned)P, (unsigned)a.H),
                                    dim3(kThreads), params, bytes, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype, r_dtype: 0 = float32, 1 = bfloat16.  xpre strides (in elements)
// {b, s, gate, head}; the hd stride is 1.  units: hidden units per CTA, a
// power of two up to 64 (P = ceil(hd / units) CTAs per head).  hbuf is
// (2, B, H, hd) f32 scratch; arrive is (H,) unsigned and must be zero.
int mlego_slstm_scan(const void* xpre, const void* r_mat, const float* c0,
                     const float* n0, const float* h0, const float* m0,
                     void* out, float* c1, float* n1, float* h1, float* m1,
                     float* hbuf, unsigned* arrive, int x_dtype, int r_dtype,
                     int B, int S, int H, int hd, int units, long long xs_b,
                     long long xs_s, long long xs_g, long long xs_h,
                     void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 1 || units < 1 || units > 64 ||
      (units & (units - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{xpre, r_mat, c0, n0, h0, m0, out, c1, n1, h1, m1, hbuf,
               arrive, B, S, H, hd, units, xs_b, xs_s, xs_g, xs_h};
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && r_dtype == 0) return launch<float, float>(a, s);
  if (x_dtype == 0 && r_dtype == 1) return launch<float, __nv_bfloat16>(a, s);
  if (x_dtype == 1 && r_dtype == 0) return launch<__nv_bfloat16, float>(a, s);
  if (x_dtype == 1 && r_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
