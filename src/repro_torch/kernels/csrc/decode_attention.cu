// Split-K flash decode for Hopper: one new token per sequence attends to
// its KV cache.
//
//   out[b, 0, h] = softmax_j(q[b, 0, h] . k[b, j, h/G] / sqrt(hd)) v[b, j, h/G]
//
// over the cache positions j <= pos (and j > pos - window when window > 0).
// q (B, 1, H, hd), caches (B, S, KVH, hd), f32 or bf16, read through their
// strides (the last dimension must be contiguous); pos is an int32 scalar
// in device memory, read by the kernel (the counterpart of the Pallas
// kernel's scalar prefetch), so a step needs no host round trip.
//
// Replaces the Pallas kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py:71).
//
// Bound: bytes.  Each step reads every live cache row once (at the serve
// path's shape, B = 4, pos = 2,100, KVH = 8, hd = 128, bf16: ~34 MB) and
// does ~4 flops per byte.  The design:
//  - the cache stays in the model's (B, S, KVH, hd) layout: no transpose of
//    the whole cache each step, as the Pallas wrapper does;
//  - split-K: grid (split, kv head, batch), each CTA walks its share of the
//    positions for all G heads that share the kv head, so a K/V row is read
//    once per group; it reads nothing beyond pos or below the window, and a
//    split that lies wholly outside [lo, pos] writes m = -inf, l = 0;
//  - K tiles go through shared memory (coalesced loads, one dot per
//    (head, key) pair); V rows are read straight from device memory with
//    consecutive threads on consecutive dims;
//  - a second launch combines the splits' (acc, m, l) in a fixed order.
// No atomics, and every reduction has a fixed order, so the result is the
// same bit for bit on every run.  fp32 inside; bf16 converted with the
// intrinsics only.  This first kernel uses CUDA cores only.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxElems = 16;  // G * hd <= kThreads * kMaxElems
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial(const T* __restrict__ q, const T* __restrict__ kc,
               const T* __restrict__ vc, const int* __restrict__ pos_ptr,
               float* __restrict__ part_acc, float* __restrict__ part_ml,
               int S, int KVH, int G, long long q_sb, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh, int window,
               float scale, int chunk) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [G][HD]
  float* Ks = Qs + G * HD;               // [kTK][HD + 1]
  float* Ps = Ks + kTK * (HD + 1);       // [G][kTK]
  float* Ms = Ps + G * kTK;              // [G] running max
  float* Ls = Ms + G;                    // [G] running sum
  float* Cs = Ls + G;                    // [G] this tile's rescale

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int E = G * HD;

  const int pos = *pos_ptr;
  const int hi = min(pos, S - 1);                       // last live key
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int start = max(lo, split * chunk);
  const int end = min(hi + 1, (split + 1) * chunk);     // exclusive

  for (int e = tid; e < E; e += kThreads) {
    const int g = e / HD, d = e - (e / HD) * HD;
    Qs[e] = to_f(q[b * q_sb + (long long)(kvh * G + g) * q_sh + d]) * scale;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  float acc[kMaxElems];
#pragma unroll
  for (int i = 0; i < kMaxElems; ++i) acc[i] = 0.f;

  const T* kbase = kc + b * k_sb + (long long)kvh * k_sh;
  const T* vbase = vc + b * v_sb + (long long)kvh * v_sh;
  for (int t0 = start; t0 < end; t0 += kTK) {
    const int n = min(kTK, end - t0);
    __syncthreads();                       // Qs ready / last tile done
    for (int idx = tid; idx < n * HD; idx += kThreads) {
      const int j = idx / HD, d = idx - (idx / HD) * HD;
      Ks[j * (HD + 1) + d] = to_f(kbase[(long long)(t0 + j) * k_ss + d]);
    }
    __syncthreads();
    for (int idx = tid; idx < G * kTK; idx += kThreads) {
      const int g = idx / kTK, j = idx - (idx / kTK) * kTK;
      float s = kNegInf;
      if (j < n) {
        const float* qr = Qs + g * HD;
        const float* kr = Ks + j * (HD + 1);
        s = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) s += qr[d] * kr[d];
      }
      Ps[idx] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {
      float* pr = Ps + g * kTK;
      float mx = kNegInf;
      for (int j = lane; j < kTK; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTK; j += 32) {
        const float p = j < n ? expf(pr[j] - m_new) : 0.f;
        pr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float coef = expf(m_old - m_new);
        Ls[g] = Ls[g] * coef + sum;
        Ms[g] = m_new;
        Cs[g] = coef;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxElems; ++i) {
      const int e = tid + i * kThreads;
      if (e >= E) break;
      const int g = e / HD, d = e - (e / HD) * HD;
      const float* pr = Ps + g * kTK;
      float a = acc[i] * Cs[g];
      for (int j = 0; j < n; ++j)
        a += pr[j] * to_f(vbase[(long long)(t0 + j) * v_ss + d]);
      acc[i] = a;
    }
  }
  __syncthreads();

  const long long slot = ((long long)b * KVH + kvh) * n_split + split;
#pragma unroll
  for (int i = 0; i < kMaxElems; ++i) {
    const int e = tid + i * kThreads;
    if (e >= E) break;
    part_acc[slot * E + e] = acc[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    part_ml[slot * 2 * G + g] = Ms[g];
    part_ml[slot * 2 * G + G + g] = Ls[g];
  }
}

// out[b, 0, kvh*G + g, d] from the n_split partials, split 0 first
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, T* __restrict__ out,
               int KVH, int G, int HD, int n_split) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int E = G * HD;
  const long long base = ((long long)b * KVH + kvh) * n_split;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int g = e / HD;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, part_ml[(base + s) * 2 * G + g]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float c = expf(part_ml[(base + s) * 2 * G + g] - M);
      L += part_ml[(base + s) * 2 * G + G + g] * c;
      A += part_acc[(base + s) * E + e] * c;
    }
    // out is (B, 1, H, HD) contiguous: head kvh*G + g, dim e - g*HD
    from_f(out + ((long long)b * KVH + kvh) * E + e, A / fmaxf(L, 1e-30f));
  }
}

template <int HD>
constexpr int partial_smem_floats(int G) {
  return G * HD + kTK * (HD + 1) + G * kTK + 3 * G;
}

template <typename T, int HD>
int launch(const void* q, const void* kc, const void* vc, const int* pos,
           void* out, float* part_acc, float* part_ml, int B, int S, int H,
           int KVH, const long long* st, int window, float scale,
           int n_split, int chunk, cudaStream_t stream) {
  const int G = H / KVH;
  const int bytes = partial_smem_floats<HD>(G) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)n_split, (unsigned)KVH, (unsigned)B);
  decode_partial<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), pos, part_acc, part_ml, S, KVH, G, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], window, scale, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T><<<dim3((unsigned)KVH, (unsigned)B), kThreads, 0,
                      stream>>>(part_acc, part_ml, static_cast<T*>(out), KVH,
                                G, HD, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* kc, const void* vc,
             const int* pos, void* out, float* pa, float* pm, int B, int S,
             int H, int KVH, const long long* st, int window, float scale,
             int n_split, int chunk, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, kc, vc, pos, out, pa, pm, B, S, H, KVH, st, window, scale, n_split, chunk, s);
    case 32: return launch<T, 32>(q, kc, vc, pos, out, pa, pm, B, S, H, KVH, st, window, scale, n_split, chunk, s);
    case 64: return launch<T, 64>(q, kc, vc, pos, out, pa, pm, B, S, H, KVH, st, window, scale, n_split, chunk, s);
    case 128: return launch<T, 128>(q, kc, vc, pos, out, pa, pm, B, S, H, KVH, st, window, scale, n_split, chunk, s);
    case 256: return launch<T, 256>(q, kc, vc, pos, out, pa, pm, B, S, H, KVH, st, window, scale, n_split, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides (in elements):
// {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh}; the head_dim stride is
// 1.  part_acc (B, KVH, n_split, G*hd) and part_ml (B, KVH, n_split, 2G)
// are f32 scratch; split s covers positions [s*chunk, (s+1)*chunk).  Two
// launches: the partials, then their combine.
int mlego_decode_attention(const void* q, const void* k_cache,
                           const void* v_cache, const int* pos, void* out,
                           float* part_acc, float* part_ml, int dtype, int B,
                           int S, int H, int KVH, int hd, long long q_sb,
                           long long q_sh, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, int window, float scale,
                           int n_split, int chunk, void* stream) {
  if (KVH < 1 || H % KVH != 0 || (H / KVH) * hd > kThreads * kMaxElems ||
      S < 1 || B < 1 || n_split < 1 || (long long)n_split * chunk < S)
    return (int)cudaErrorInvalidValue;
  const long long st[8] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(hd, q, k_cache, v_cache, pos, out, part_acc,
                           part_ml, B, S, H, KVH, st, window, scale, n_split,
                           chunk, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k_cache, v_cache, pos, out,
                                   part_acc, part_ml, B, S, H, KVH, st,
                                   window, scale, n_split, chunk, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
