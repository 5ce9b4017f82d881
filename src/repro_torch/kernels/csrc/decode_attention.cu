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
// does ~4 flops per byte, so what counts is how many bytes each SM keeps
// in flight (by Little's law some tens of KB) and how little else a CTA
// waits on.  The design:
//  - the cache stays in the model's (B, S, KVH, hd) layout: no transpose of
//    the whole cache each step, as the Pallas wrapper does;
//  - split-K: grid (split, kv head, batch), each CTA walks its chunk of the
//    positions for all G heads that share the kv head, so a K/V row is read
//    once per group.  The split plan (ops.py::split_plan) cuts the cache
//    into chunks of whole 64-key tiles, enough for about three waves of
//    CTAs on 132 SMs whatever B x KVH is (at most 64 chunks): at the
//    served shape 11 chunks of 192, so 11 x 8 x 4 = 352 CTAs, each with
//    64 KB in flight (there one-tile chunks, three times the CTAs, were
//    slower: each CTA pays the pos read, the q rows and the partial writes
//    for half the bytes); one sequence (B x KVH = 8) gets 33 of 64;
//  - bf16 (decode_partial_bf16, the serve path): K and V tiles come into
//    shared memory by 16-byte cp.async through a 2-stage ring (rows padded
//    by 16 bytes; rows past the chunk zero-filled, never read).  Both
//    products run on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
//    accumulate) with the G query heads padded to 16-row m-tiles: warp w
//    takes keys [16w, 16w + 16) of each tile, S = Q K^T from ldmatrix
//    fragments, an online softmax of its own in f32, and P (rounded to bf16
//    in registers, as in the prefill kernel) times V by ldmatrix.trans.  So
//    no thread walks a whole hd alone and nothing waits on a shuffle chain
//    per key.  The four warps' (m, l, O) are merged in a fixed order;
//  - f32 (decode_partial_f32, the 1e-5 checks): CUDA cores, K tiles
//    through shared memory with one dot per (head, key) pair, V read from
//    device memory;
//  - nothing is read beyond pos or below the window: a split that lies
//    wholly outside [lo, pos] returns at once, and the combine (a second
//    launch) reads only the live splits, in split order, from pos.
// No atomics, and every reduction has a fixed order, so the result is the
// same bit for bit on every run.
//
// One shard of a split-K decode over a sequence-sharded cache
// (models/attention.py): the shard is called with pos - start, so a shard
// past pos sees pos < 0 and one wholly below the window sees lo > hi; such
// a shard has no live split, and the combine writes 0 (and lse = -inf)
// without reading a partial.  With lse given, the combine writes each
// head's natural log-sum-exp of its scaled scores to lse (B, 1, H) f32 and
// out in f32, so the shards are combined before one final cast.  bf16 is converted with the intrinsics
// only.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_ptx.cuh"

namespace {

using namespace mlego;

constexpr int kTK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxElems = 16;  // G * hd <= kThreads * kMaxElems
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void live_range(const int* pos_ptr, int S,
                                           int window, int* lo, int* hi) {
  const int pos = *pos_ptr;
  *hi = min(pos, S - 1);                                // last live key
  *lo = window > 0 ? max(0, pos - window + 1) : 0;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, 16-byte copies through a shared-memory ring
// ---------------------------------------------------------------------------

// 16-row m-tiles of query heads: G * hd <= 2048 allows G up to 2048 / hd
template <int HD>
__host__ __device__ constexpr int head_tiles() {
  return HD >= 128 ? 1 : 128 / HD;
}

// shared memory of the bf16 partial kernel, in bytes: the ring (or, after
// the loop, the four warps' partial sums in its place), then Q
template <int HD>
__host__ __device__ int bf16_smem_bytes(int G, int n_stage) {
  const int ring = n_stage * 2 * kTK * (HD + 8) * 2;
  const int red = kThreads / 32 * (G * HD + 2 * G) * 4;
  return (ring > red ? ring : red) + 16 * head_tiles<HD>() * (HD + 8) * 2;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial_bf16(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    const int* __restrict__ pos_ptr,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int S, int KVH, int G,
                    long long q_sb, long long q_sh, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb,
                    long long v_ss, long long v_sh, int window, float scale,
                    int chunk, int n_stage) {
  constexpr int LD = HD + 8;       // bf16 per padded smem row
  constexpr int C = HD / 8;        // 16-byte chunks per row
  constexpr int KC = HD / 16;      // k-steps of Q K^T
  constexpr int NT = HD / 8;       // n-tiles of O
  constexpr int MT = head_tiles<HD>();
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int ring_b = n_stage * 2 * kTK * LD * 2;
  const int red_b = kWarps * (G * HD + 2 * G) * 4;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (ring_b > red_b ? ring_b : red_b));   // [16 MT][LD]

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int lo, hi;
  live_range(pos_ptr, S, window, &lo, &hi);
  const int start = max(lo, split * chunk);
  const int end = min(hi + 1, (split + 1) * chunk);     // exclusive
  if (start >= end) return;        // not live: the combine skips it

  const __nv_bfloat16* kbase = kc + b * k_sb + (long long)kvh * k_sh;
  const __nv_bfloat16* vbase = vc + b * v_sb + (long long)kvh * v_sh;
  const int n_tiles = (end - start + kTK - 1) / kTK;
  auto load = [&](int t, int stage) {
    __nv_bfloat16* Ks = ring + stage * 2 * kTK * LD;
    __nv_bfloat16* Vs = Ks + kTK * LD;
    const int t0 = start + t * kTK;
    for (int idx = tid; idx < kTK * C; idx += kThreads) {
      const int j = idx / C, c = idx - (idx / C) * C;
      const bool ok = t0 + j < end;            // zero-filled past the end
      const long long row = t0 + j;
      cp_async16(Ks + j * LD + c * 8, ok ? kbase + row * k_ss + c * 8 : kc,
                 ok);
      cp_async16(Vs + j * LD + c * 8, ok ? vbase + row * v_ss + c * 8 : vc,
                 ok);
    }
  };
  load(0, 0);
  cp_async_commit();

  // the group's q rows as bf16, padded with zero rows to 16 MT
  for (int idx = tid; idx < 16 * MT * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - (idx / HD) * HD;
    Qs[r * LD + d] = r < G ? q[b * q_sb + (long long)(kvh * G + r) * q_sh + d]
                           : __float2bfloat16(0.f);
  }

  // warp w keeps its own online softmax over keys [16w, 16w + 16) of
  // every tile; the four warps are merged at the end
  float o[MT][NT][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int kb_row = warp * 16 + (lane & 7) + (lane >> 4) * 8;
  const int kb_col = ((lane >> 3) & 1) * 8;
  const int vb_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vb_col = (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = n_stage > 1 ? (t & 1) : 0;
    cp_async_wait<0>();            // this tile has landed,
    __syncthreads();               // for all (and Qs is written)
    if (n_stage > 1 && t + 1 < n_tiles) {
      load(t + 1, stage ^ 1);      // the next tile lands during this one
      cp_async_commit();
    }
    const __nv_bfloat16* Ks = ring + stage * 2 * kTK * LD;
    const __nv_bfloat16* Vs = Ks + kTK * LD;
    const int n = min(kTK, end - (start + t * kTK));
    if (warp * 16 < n) {           // warp-uniform: this warp has keys
      // S = Q K^T: 16 MT heads x 16 keys, f32
      float s[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][0][e] = s[mt][1][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Ks + kb_row * LD + kc * 16 + kb_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt * 16 >= G) break;
          uint32_t a[4];
          ldmatrix_x4(a, Qs + (mt * 16 + a_row) * LD + kc * 16 + a_col);
          mma_bf16(s[mt][0], a, bk[0], bk[1]);
          mma_bf16(s[mt][1], a, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt * 16 >= G) break;
        // scale the f32 scores; keys past the tile's end are masked
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = warp * 16 + nt * 8 + (lane & 3) * 2 + (e & 1);
            const float x = j < n ? s[mt][nt][e] * scale : kNegInf;
            s[mt][nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float coef[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1)
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
          const float mn = fmaxf(m[mt][h], mx[h]);
          coef[h] = expf(m[mt][h] - mn);
          m[mt][h] = mn;
          l[mt][h] *= coef[h];
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[mt][nt][e];
            const float p = x == kNegInf ? 0.f : expf(x - m[mt][e >> 1]);
            s[mt][nt][e] = p;
            l[mt][e >> 1] += p;
          }
#pragma unroll
        for (int n2 = 0; n2 < NT; ++n2) {
          o[mt][n2][0] *= coef[0];
          o[mt][n2][1] *= coef[0];
          o[mt][n2][2] *= coef[1];
          o[mt][n2][3] *= coef[1];
        }
        // O += P V over the warp's 16 keys, P rounded to bf16 in registers
        uint32_t a[4];
        a[0] = pack_bf16(s[mt][0][0], s[mt][0][1]);
        a[1] = pack_bf16(s[mt][0][2], s[mt][0][3]);
        a[2] = pack_bf16(s[mt][1][0], s[mt][1][1]);
        a[3] = pack_bf16(s[mt][1][2], s[mt][1][3]);
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vs + vb_row * LD + dp * 16 + vb_col);
          mma_bf16(o[mt][2 * dp], a, bv[0], bv[1]);
          mma_bf16(o[mt][2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    if (n_stage == 1 && t + 1 < n_tiles) {
      __syncthreads();             // every warp is done with the stage
      load(t + 1, 0);
      cp_async_commit();
    }
  }
  __syncthreads();                 // the ring is free: the sums go there

  // each warp's (m, l, O) for the G real rows, then a fixed-order merge
  float* Ro = reinterpret_cast<float*>(smem_raw);    // [warp][G][HD]
  float* Rm = Ro + kWarps * G * HD;                  // [warp][G]
  float* Rl = Rm + kWarps * G;                       // [warp][G]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[mt][h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, off);
      const int r = mt * 16 + h * 8 + (lane >> 2);
      if (r >= G) continue;
      if ((lane & 3) == 0) {
        Rm[warp * G + r] = m[mt][h];
        Rl[warp * G + r] = lt;
      }
      float* dst = Ro + ((long long)warp * G + r) * HD + (lane & 3) * 2;
#pragma unroll
      for (int n2 = 0; n2 < NT; ++n2) {
        dst[n2 * 8] = o[mt][n2][2 * h];
        dst[n2 * 8 + 1] = o[mt][n2][2 * h + 1];
      }
    }
  }
  __syncthreads();
  const int E = G * HD;
  const long long slot = ((long long)b * KVH + kvh) * n_split + split;
  for (int e = tid; e < E; e += kThreads) {
    const int g = e / HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Rm[w * G + g]);
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      A += Ro[w * E + e] * expf(Rm[w * G + g] - M);
    part_acc[slot * E + e] = A;
  }
  for (int g = tid; g < G; g += kThreads) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Rm[w * G + g]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      L += Rl[w * G + g] * expf(Rm[w * G + g] - M);
    part_ml[slot * 2 * G + g] = M;
    part_ml[slot * 2 * G + G + g] = L;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, K through shared memory
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial_f32(const float* __restrict__ q, const float* __restrict__ kc,
                   const float* __restrict__ vc,
                   const int* __restrict__ pos_ptr,
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

  int lo, hi;
  live_range(pos_ptr, S, window, &lo, &hi);
  const int start = max(lo, split * chunk);
  const int end = min(hi + 1, (split + 1) * chunk);     // exclusive
  if (start >= end) return;        // not live: the combine skips it

  for (int e = tid; e < E; e += kThreads) {
    const int g = e / HD, d = e - (e / HD) * HD;
    Qs[e] = q[b * q_sb + (long long)(kvh * G + g) * q_sh + d] * scale;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  float acc[kMaxElems];
#pragma unroll
  for (int i = 0; i < kMaxElems; ++i) acc[i] = 0.f;

  const float* kbase = kc + b * k_sb + (long long)kvh * k_sh;
  const float* vbase = vc + b * v_sb + (long long)kvh * v_sh;
  for (int t0 = start; t0 < end; t0 += kTK) {
    const int n = min(kTK, end - t0);
    __syncthreads();                       // Qs ready / last tile done
    for (int idx = tid; idx < n * HD; idx += kThreads) {
      const int j = idx / HD, d = idx - (idx / HD) * HD;
      Ks[j * (HD + 1) + d] = kbase[(long long)(t0 + j) * k_ss + d];
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
        a += pr[j] * vbase[(long long)(t0 + j) * v_ss + d];
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

// out[b, 0, kvh*G + g, d] from the live splits' partials, in split order.
// The live splits' (m, l) go to shared memory first, each head's weights
// exp(m_s - M) are formed there once, and every thread then reads its
// element of all live splits with the loads in flight together.
constexpr int kCombineThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml,
               const int* __restrict__ pos_ptr, T* __restrict__ out, int S,
               int KVH, int G, int HD, int n_split, int chunk, int window,
               float* __restrict__ lse) {
  extern __shared__ float cs[];   // [n_live][2G] (m, l), [n_live][G] w, [G] L
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int E = G * HD;
  int lo, hi;
  live_range(pos_ptr, S, window, &lo, &hi);
  const int s_lo = lo / chunk;
  // no live key (a shard past pos, or below the window): no partial
  const int n_live = hi < lo ? 0 : min(hi / chunk, n_split - 1) - s_lo + 1;
  const long long base = ((long long)b * KVH + kvh) * n_split + s_lo;
  float* ml = cs;
  float* w = ml + n_live * 2 * G;
  float* Ls = w + n_live * G;
  for (int i = threadIdx.x; i < n_live * 2 * G; i += kCombineThreads)
    ml[i] = part_ml[base * 2 * G + i];
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kCombineThreads) {
    float M = kNegInf;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, ml[s * 2 * G + g]);
    float L = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float c = expf(ml[s * 2 * G + g] - M);
      w[s * G + g] = c;
      L += ml[s * 2 * G + G + g] * c;
    }
    Ls[g] = L;
    if (lse != nullptr && blockIdx.x == 0)
      lse[((long long)b * KVH + kvh) * G + g] =
          L > 0.f ? (M + logf(L)) : -INFINITY;
  }
  __syncthreads();
  const int e = blockIdx.x * kCombineThreads + threadIdx.x;
  if (e >= E) return;
  const int g = e / HD;
  const float* pa = part_acc + base * E + e;
  float A = 0.f;
  int s = 0;
  for (; s + 8 <= n_live; s += 8) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = pa[(long long)(s + i) * E];
#pragma unroll
    for (int i = 0; i < 8; ++i) A += x[i] * w[(s + i) * G + g];
  }
  for (; s < n_live; ++s) A += pa[(long long)s * E] * w[s * G + g];
  // out is (B, 1, H, HD) contiguous: head kvh*G + g, dim e - g*HD
  store(out + ((long long)b * KVH + kvh) * E + e, A / fmaxf(Ls[g], 1e-30f));
}

template <typename T>
int launch_combine(const float* part_acc, const float* part_ml,
                   const int* pos, void* out, int B, int S, int KVH, int G,
                   int HD, int n_split, int chunk, int window, float* lse,
                   cudaStream_t stream) {
  const int E = G * HD;
  const int bytes = (n_split * 3 * G + G) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_combine<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((E + kCombineThreads - 1) / kCombineThreads),
            (unsigned)KVH, (unsigned)B);
  decode_combine<T><<<grid, kCombineThreads, bytes, stream>>>(
      part_acc, part_ml, pos, static_cast<T*>(out), S, KVH, G, HD, n_split,
      chunk, window, lse);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* kc, const void* vc, const int* pos,
                void* out, float* part_acc, float* part_ml, int B, int S,
                int H, int KVH, const long long* st, int window, float scale,
                int n_split, int chunk, float* lse, cudaStream_t stream) {
  const int G = H / KVH;
  if (G > 16 * head_tiles<HD>()) return (int)cudaErrorInvalidValue;
  const int n_stage = chunk > kTK ? 2 : 1;
  const int bytes = bf16_smem_bytes<HD>(G, n_stage);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)n_split, (unsigned)KVH, (unsigned)B);
  decode_partial_bf16<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), pos, part_acc, part_ml, S, KVH,
      G, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], window,
      scale, chunk, n_stage);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (lse != nullptr)             // f32 out beside the lse
    return launch_combine<float>(part_acc, part_ml, pos, out, B, S, KVH, G,
                                 HD, n_split, chunk, window, lse, stream);
  return launch_combine<__nv_bfloat16>(part_acc, part_ml, pos, out, B, S,
                                       KVH, G, HD, n_split, chunk, window,
                                       nullptr, stream);
}

template <int HD>
int launch_f32(const void* q, const void* kc, const void* vc, const int* pos,
               void* out, float* part_acc, float* part_ml, int B, int S,
               int H, int KVH, const long long* st, int window, float scale,
               int n_split, int chunk, float* lse, cudaStream_t stream) {
  const int G = H / KVH;
  const int bytes =
      (G * HD + kTK * (HD + 1) + G * kTK + 3 * G) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)n_split, (unsigned)KVH, (unsigned)B);
  decode_partial_f32<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), pos, part_acc, part_ml, S, KVH, G,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], window, scale,
      chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<float>(part_acc, part_ml, pos, out, B, S, KVH, G, HD,
                               n_split, chunk, window, lse, stream);
}

using Launch = int (*)(const void*, const void*, const void*, const int*,
                       void*, float*, float*, int, int, int, int,
                       const long long*, int, float, int, int, float*,
                       cudaStream_t);

Launch pick(int dtype, int hd) {
  switch (hd) {
    case 16: return dtype == 0 ? launch_f32<16> : launch_bf16<16>;
    case 32: return dtype == 0 ? launch_f32<32> : launch_bf16<32>;
    case 64: return dtype == 0 ? launch_f32<64> : launch_bf16<64>;
    case 128: return dtype == 0 ? launch_f32<128> : launch_bf16<128>;
    case 256: return dtype == 0 ? launch_f32<256> : launch_bf16<256>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides (in elements):
// {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh}; the head_dim stride is
// 1.  part_acc (B, KVH, n_split, G*hd) and part_ml (B, KVH, n_split, 2G)
// are f32 scratch; split s covers positions [s*chunk, (s+1)*chunk), and
// chunk is a multiple of 64.  bf16 needs the caches 16-byte aligned and
// their strides multiples of 8 elements (16-byte copies).  Two launches:
// the partials, then their combine.  lse (B, 1, H) f32 or null; out is
// f32 when lse is given (or dtype is 0), else bf16.
int mlego_decode_attention(const void* q, const void* k_cache,
                           const void* v_cache, const int* pos, void* out,
                           float* part_acc, float* part_ml, int dtype, int B,
                           int S, int H, int KVH, int hd, long long q_sb,
                           long long q_sh, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, int window, float scale,
                           int n_split, int chunk, float* lse, void* stream) {
  if (KVH < 1 || H % KVH != 0 || (H / KVH) * hd > kThreads * kMaxElems ||
      S < 1 || B < 1 || n_split < 1 || chunk < kTK || chunk % kTK != 0 ||
      (long long)n_split * chunk < S || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long st[8] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  if (dtype == 1) {
    const uintptr_t ptrs = (uintptr_t)k_cache | (uintptr_t)v_cache;
    const long long strides = k_sb | k_ss | k_sh | v_sb | v_ss | v_sh;
    if ((ptrs & 15) != 0 || (strides & 7) != 0)
      return (int)cudaErrorMisalignedAddress;
  }
  const Launch fn = pick(dtype, hd);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k_cache, v_cache, pos, out, part_acc, part_ml, B, S, H, KVH,
            st, window, scale, n_split, chunk, lse, (cudaStream_t)stream);
}

}  // extern "C"
