// GQA causal / sliding-window flash attention (prefill) for Hopper.
//
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(hd)) v[b, j, h/G]
//
// over the keys j that the mask keeps (j <= i when causal, i - j < window
// when window > 0).  q (B, S, H, hd), k and v (B, S, KVH, hd), f32 or bf16,
// read through their strides (the last dimension must be contiguous);
// out (B, S, H, hd) contiguous, in the input's type.
//
// Replaces the Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:85).
//
// Bound: operations.  At the serve path's shape (B = 4, S = 2,048, H = 16,
// KVH = 8, hd = 128, causal) one call does ~69 GFLOP against ~8 MB of q, k,
// v and out, far above the card's ridge point.  This first kernel runs the
// two products on CUDA-core FMAs in fp32 (no mma.sync, wgmma or TMA yet),
// so it reaches at best the fp32 rate (67 TFLOP/s), not the tensor cores'
// 989; making it fast is later work.  What the design does about the bound:
//  - one CTA per (q tile, kv head, batch) holds the G query heads that share
//    the kv head as extra rows (64 rows = G x BQ query positions), so every
//    K/V tile read from device memory serves all G heads, as on the TPU;
//  - the TPU's sequential innermost KV grid axis becomes a loop inside the
//    CTA, with the online-softmax state (m, l, acc) in registers;
//  - tiles above the causal diagonal and below the window band are never
//    visited, and the heaviest (last) q tiles are scheduled first;
//  - each thread computes a 4 x 4 block of scores and a 4 x hd/16 block of
//    the output from shared memory (padded rows: no bank conflicts on K).
// The inputs are read in their own (B, S, heads, hd) layout: no transpose
// copy as in the Pallas wrapper.  The mask reaches both the scores and p,
// so a fully masked row (a ragged edge, an idle row) adds nothing: its
// exp(NEG_INF - NEG_INF) = 1 is zeroed.  Arithmetic is fp32 inside, as in
// the Pallas kernel; bf16 is converted with the intrinsics only.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;       // G * BQ query rows per CTA (some may idle)
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
constexpr int smem_floats() {
  return kRows * (HD + 1) + kBK * (HD + 1) + kBK * HD + kRows * (kBK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int S, int H,
          int KVH, int G, int BQ, long long q_sb, long long q_ss,
          long long q_sh, long long k_sb, long long k_ss, long long k_sh,
          long long v_sb, long long v_ss, long long v_sh, int causal,
          int window, float scale) {
  constexpr int DJ = HD / 16;      // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                          // [kRows][HD + 1]
  float* Ks = Qs + kRows * (HD + 1);         // [kBK][HD + 1]
  float* Vs = Ks + kBK * (HD + 1);           // [kBK][HD]
  float* Ps = Vs + kBK * HD;                 // [kRows][kBK + 1]

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // heaviest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qt * BQ;
  const int used = G * BQ;                   // rows r = qi * G + g

  // the query tile, scaled, as f32
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - (idx / HD) * HD;
    const int qi = r / G, g = r - (r / G) * G;
    float x = 0.f;
    if (r < used && q0 + qi < S) {
      x = to_f(q[b * q_sb + (long long)(q0 + qi) * q_ss +
                 (long long)(kvh * G + g) * q_sh + d]) * scale;
    }
    Qs[r * (HD + 1) + d] = x;
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int p = q0 + r / G;
    qpos[i] = (r < used && p < S) ? p : -1;   // -1: an idle row
  }
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // the KV tiles this q tile can see
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int kt_hi = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  int kt_lo = 0;
  if (window > 0) {
    const int kmin = q0 - window + 1;
    kt_lo = kmin > 0 ? kmin / kBK : 0;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // the last tile's Ks/Vs/Ps are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx - (idx / HD) * HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < S) {
        kx = to_f(k[b * k_sb + (long long)(k0 + j) * k_ss +
                    (long long)kvh * k_sh + d]);
        vx = to_f(v[b * v_sb + (long long)(k0 + j) * v_ss +
                    (long long)kvh * v_sh + d]);
      }
      Ks[j * (HD + 1) + d] = kx;
      Vs[j * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float* qrow = Qs + ty * (HD + 1);
    const float* krow = Ks + tx * (HD + 1);
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qrow[16 * i * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = krow[16 * j * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * c[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool valid = qpos[i] >= 0 && kp < S;
        if (causal) valid = valid && kp <= qpos[i];
        if (window > 0) valid = valid && qpos[i] - kp < window;
        ok[j] = valid;
        s[i][j] = valid ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes that share a row are one half warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float coef = expf(m[i] - m_new);
      l[i] = l[i] * coef + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= coef;
    }
    __syncthreads();

    const float* prow = Ps + ty * (kBK + 1);
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = prow[16 * i * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vx = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vx;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] < 0) continue;
    const int r = ty + 16 * i;
    const int h = kvh * G + (r - (r / G) * G);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* dst = out + (((long long)b * S + qpos[i]) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) from_f(dst + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KVH, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const int BQ = kRows / G;
  const int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)KVH, (unsigned)B);
  flash_fwd<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KVH, G, BQ,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int B, int S, int H, int KVH, const long long* st, int causal,
             int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, KVH, st, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KVH, st, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KVH, st, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, KVH, st, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, S, H, KVH, st, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides (in elements) of q, k, v:
// {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh}; the head_dim
// stride is 1.  Needs H % KVH == 0 and H / KVH <= 64.
int mlego_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int dtype, int B, int S, int H, int KVH,
                          int hd, long long q_sb, long long q_ss,
                          long long q_sh, long long k_sb, long long k_ss,
                          long long k_sh, long long v_sb, long long v_ss,
                          long long v_sh, int causal, int window, float scale,
                          void* stream) {
  if (KVH < 1 || H % KVH != 0 || H / KVH > kRows || S < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                           k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, out, B, S, H, KVH, st, causal,
                           window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, out, B, S, H, KVH, st,
                                   causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
