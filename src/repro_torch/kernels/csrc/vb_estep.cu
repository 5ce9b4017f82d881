// Fused LDA variational E-step for Hopper, in two launches.
//
// Replaces the Pallas kernel vb_estep_pallas
// (src/repro/kernels/vb_estep/vb_estep.py:76).  It computes, for
// x (D, V), eeb = exp(E[log beta]) (K, V) and gamma0 (D, K):
//
//   repeat n_iters:
//     eet     = exp(psi(gamma) - psi(sum_k gamma))           (D, K)
//     phinorm = eet . eeb + 1e-30                            (D, V)
//     gamma   = alpha + eet * ((x / phinorm) . eeb^T)        (D, K)
//   sstats = (eet^T . (x / phinorm)) * eeb                   (K, V)
//
// psi is the same 8-step shift plus asymptotic series as the TPU kernel
// (vb_estep.py:29-41), not a library digamma.  Everything is fp32 with no
// TF32, so the result stays within 2e-4 of the plain version.
//
// Bound: operations.  The two products per iteration are 4*D*K*V flops
// against D*V*4 bytes of x, far above the card's fp32 ridge point.  (Most
// entries of a real doc-term x are zero, so a sparse form would need far
// fewer operations; this dense kernel keeps the TPU kernel's arithmetic.)
//
// Launch (a), estep_iters: one CTA per block of BD documents.  gamma and
// eet of the block stay in shared memory for all n_iters iterations; each
// iteration streams V in tiles of TV columns: x tile and eeb tile into
// shared memory, the phinorm tile and the ratio x / phinorm, then the
// (BD, K) product is added up in registers across all tiles.  It writes
// gamma and the final eet.
//
// Launch (b), estep_sstats: the TPU kernel adds every doc block into one
// (K, V) output that each grid step revisits in order.  GPU blocks run in
// no order, so instead one CTA owns a tile of TV2 vocabulary columns for
// all K topics and loops over the documents in chunks: it recomputes
// phinorm for the chunk from eet and its eeb tile, adds eet^T . ratio in
// registers, and multiplies by eeb at the end.  No atomics and no (K, V)
// partial per doc block; the sum order is fixed, so every run gives the
// same answer.  Rows past D are loaded as zeros (x and eet), so a ragged
// last chunk adds nothing.
//
// K is not padded: the kernels loop over exactly K topics (the k-slots of
// a template instance beyond K read zero rows or are skipped).  The TPU
// wrapper pads K to 128 with eeb = 1e-30; that is harmless there because
// a common factor of eet cancels between phinorm and the gamma update,
// and it is simply not needed here.
#include <cuda_runtime.h>

namespace {

constexpr int BD = 16;          // documents per CTA, launch (a)
constexpr int TV = 64;          // vocabulary columns per tile, launch (a)
constexpr int TVP = TV + 1;     // padded row stride of the eeb tile
constexpr int kThreadsA = 128;  // 4 warps x 4 documents
constexpr int BD2 = 32;         // documents per chunk, launch (b)
constexpr int TV2 = 32;         // vocabulary columns per CTA, launch (b)
constexpr int kThreadsB = 256;  // 8 warps x 4 documents

__device__ __forceinline__ float digamma_series(float x) {
  float shift = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool small = x < 8.f;
    shift -= small ? 1.f / x : 0.f;
    x = small ? x + 1.f : x;
  }
  const float inv = 1.f / x;
  const float inv2 = inv * inv;
  const float series =
      logf(x) - 0.5f * inv -
      inv2 * (1.f / 12.f - inv2 * (1.f / 120.f - inv2 / 252.f));
  return series + shift;
}

// eet_t[k][d] = exp(psi(g[d][k]) - psi(sum_k g[d][k])) for the BD docs of
// the CTA; each of the 4 warps takes BD / 4 documents.
__device__ void exp_dirichlet_block(const float* g, float* eet_t, int K,
                                    int warp, int lane) {
  for (int i = 0; i < BD / 4; ++i) {
    const int d = warp * (BD / 4) + i;
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += g[d * K + k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const float psi_sum = digamma_series(s);
    for (int k = lane; k < K; k += 32)
      eet_t[k * BD + d] = expf(digamma_series(g[d * K + k]) - psi_sum);
  }
}

// Launch (a).  KS topic slots per lane: K <= 32 * KS.
template <int KS>
__global__ void __launch_bounds__(kThreadsA)
    estep_iters(const float* __restrict__ x, const float* __restrict__ eeb,
                const float* __restrict__ gamma0,
                float* __restrict__ gamma_out, float* __restrict__ eet_out,
                int D, int K, int V, float alpha, int n_iters) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KP = 32 * KS;
  float* b_s = smem;               // [KP][TVP]  eeb tile
  float* t_s = b_s + KP * TVP;     // [K][BD]    eet, transposed
  float* g_s = t_s + K * BD;       // [BD][K]    gamma
  float* x_s = g_s + BD * K;       // [BD][TV]   x tile
  float* r_s = x_s + BD * TV;      // [BD][TV]   x / phinorm
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d0 = blockIdx.x * BD;

  // rows K..KP-1 of the eeb tile stay zero: their k-slots add nothing
  for (int i = tid; i < (KP - K) * TVP; i += kThreadsA) b_s[K * TVP + i] = 0.f;
  for (int i = tid; i < BD * K; i += kThreadsA) {
    const int d = i / K;
    g_s[i] = (d0 + d < D) ? gamma0[(long long)d0 * K + i] : alpha;
  }
  __syncthreads();

  for (int it = 0;; ++it) {
    exp_dirichlet_block(g_s, t_s, K, warp, lane);
    __syncthreads();
    if (it == n_iters) break;

    float acc[4][KS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KS; ++j) acc[i][j] = 0.f;

    for (int v0 = 0; v0 < V; v0 += TV) {
      for (int i = tid; i < BD * TV; i += kThreadsA) {
        const int d = i / TV, vv = i % TV;
        x_s[i] = (d0 + d < D && v0 + vv < V)
                     ? x[(long long)(d0 + d) * V + v0 + vv]
                     : 0.f;
      }
      for (int i = tid; i < K * TV; i += kThreadsA) {
        const int k = i / TV, vv = i % TV;
        b_s[k * TVP + vv] =
            (v0 + vv < V) ? eeb[(long long)k * V + v0 + vv] : 0.f;
      }
      __syncthreads();

      // phinorm and ratio: thread owns column v for 8 documents
      {
        const int v = tid & (TV - 1);
        const int dg = (tid >> 6) * 8;
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = 0.f;
        for (int k = 0; k < K; ++k) {
          const float b = b_s[k * TVP + v];
          const float4 t0 = *reinterpret_cast<const float4*>(&t_s[k * BD + dg]);
          const float4 t1 =
              *reinterpret_cast<const float4*>(&t_s[k * BD + dg + 4]);
          p[0] += t0.x * b;
          p[1] += t0.y * b;
          p[2] += t0.z * b;
          p[3] += t0.w * b;
          p[4] += t1.x * b;
          p[5] += t1.y * b;
          p[6] += t1.z * b;
          p[7] += t1.w * b;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          r_s[(dg + i) * TV + v] = x_s[(dg + i) * TV + v] / (p[i] + 1e-30f);
      }
      __syncthreads();

      // acc[d][k] += sum_v ratio[d][v] * eeb[k][v]: warp owns 4 documents,
      // lane owns topics lane + 32 j
      for (int v = 0; v < TV; ++v) {
        float r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = r_s[(warp * 4 + i) * TV + v];
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const float e = b_s[(lane + 32 * j) * TVP + v];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += r[i] * e;
        }
      }
      __syncthreads();  // the next tile overwrites x_s, b_s and r_s
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = warp * 4 + i;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int k = lane + 32 * j;
        if (k < K) g_s[d * K + k] = alpha + t_s[k * BD + d] * acc[i][j];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < BD * K; i += kThreadsA) {
    const int d = i / K, k = i - d * K;
    if (d0 + d < D) {
      gamma_out[(long long)d0 * K + i] = g_s[i];
      eet_out[(long long)d0 * K + i] = t_s[k * BD + d];
    }
  }
}

// Launch (b).  4 * KS topic slots per thread: k = warp + 8 j, K <= 32 * KS.
template <int KS>
__global__ void __launch_bounds__(kThreadsB)
    estep_sstats(const float* __restrict__ x, const float* __restrict__ eeb,
                 const float* __restrict__ eet, float* __restrict__ sstats,
                 int D, int K, int V) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KJ = 4 * KS;
  float* e_s = smem;               // [K][BD2]   eet chunk, transposed
  float* b_s = e_s + K * BD2;      // [K][TV2]   eeb tile
  float* x_s = b_s + K * TV2;      // [BD2][TV2] x chunk
  float* r_s = x_s + BD2 * TV2;    // [BD2][TV2] x / phinorm
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int v0 = blockIdx.x * TV2;

  for (int i = tid; i < K * TV2; i += kThreadsB) {
    const int k = i / TV2, vv = i % TV2;
    b_s[i] = (v0 + vv < V) ? eeb[(long long)k * V + v0 + vv] : 0.f;
  }
  float acc[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < D; c0 += BD2) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < BD2 * K; i += kThreadsB) {
      const int d = i / K, k = i - d * K;
      e_s[k * BD2 + d] = (c0 + d < D) ? eet[(long long)c0 * K + i] : 0.f;
    }
    for (int i = tid; i < BD2 * TV2; i += kThreadsB) {
      const int d = i / TV2, vv = i % TV2;
      x_s[i] = (c0 + d < D && v0 + vv < V)
                   ? x[(long long)(c0 + d) * V + v0 + vv]
                   : 0.f;
    }
    __syncthreads();

    // phinorm and ratio: lane owns a column, warp 4 documents
    {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < K; ++k) {
        const float b = b_s[k * TV2 + lane];
        const float4 e = *reinterpret_cast<const float4*>(&e_s[k * BD2 + warp * 4]);
        p[0] += e.x * b;
        p[1] += e.y * b;
        p[2] += e.z * b;
        p[3] += e.w * b;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = warp * 4 + i;
        r_s[d * TV2 + lane] = x_s[d * TV2 + lane] / (p[i] + 1e-30f);
      }
    }
    __syncthreads();

    // acc[k][v] += sum_d eet[d][k] * ratio[d][v]
    for (int d = 0; d < BD2; d += 4) {
      const float r0 = r_s[(d + 0) * TV2 + lane];
      const float r1 = r_s[(d + 1) * TV2 + lane];
      const float r2 = r_s[(d + 2) * TV2 + lane];
      const float r3 = r_s[(d + 3) * TV2 + lane];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int k = warp + 8 * j;
        if (k < K) {
          const float4 e = *reinterpret_cast<const float4*>(&e_s[k * BD2 + d]);
          acc[j] += e.x * r0 + e.y * r1 + e.z * r2 + e.w * r3;
        }
      }
    }
  }

  const int v = v0 + lane;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = warp + 8 * j;
    if (k < K && v < V) sstats[(long long)k * V + v] = acc[j] * b_s[k * TV2 + lane];
  }
}

template <int KS>
cudaError_t launch_iters(const float* x, const float* eeb, const float* gamma0,
                         float* gamma, float* eet, int D, int K, int V,
                         float alpha, int n_iters, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(32 * KS * TVP + 2 * K * BD + 2 * BD * TV);
  cudaError_t e = cudaFuncSetAttribute(
      estep_iters<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((D + BD - 1) / BD);
  estep_iters<KS><<<grid, kThreadsA, smem, stream>>>(x, eeb, gamma0, gamma,
                                                     eet, D, K, V, alpha,
                                                     n_iters);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_sstats(const float* x, const float* eeb, const float* eet,
                          float* sstats, int D, int K, int V,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * K * BD2 + 2 * BD2 * TV2);
  cudaError_t e = cudaFuncSetAttribute(
      estep_sstats<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((V + TV2 - 1) / TV2);
  estep_sstats<KS><<<grid, kThreadsB, smem, stream>>>(x, eeb, eet, sstats, D,
                                                      K, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K <= 256 (the wrapper checks); D, V >= 1; n_iters >= 0.
int mlego_vb_estep_iters(const float* x, const float* eeb,
                         const float* gamma0, float* gamma, float* eet, int D,
                         int K, int V, float alpha, int n_iters,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || V < 1 || K < 1 || n_iters < 0) return (int)cudaErrorInvalidValue;
  if (K <= 32) return (int)launch_iters<1>(x, eeb, gamma0, gamma, eet, D, K, V, alpha, n_iters, s);
  if (K <= 64) return (int)launch_iters<2>(x, eeb, gamma0, gamma, eet, D, K, V, alpha, n_iters, s);
  if (K <= 128) return (int)launch_iters<4>(x, eeb, gamma0, gamma, eet, D, K, V, alpha, n_iters, s);
  if (K <= 256) return (int)launch_iters<8>(x, eeb, gamma0, gamma, eet, D, K, V, alpha, n_iters, s);
  return (int)cudaErrorInvalidValue;
}

int mlego_vb_estep_sstats(const float* x, const float* eeb, const float* eet,
                          float* sstats, int D, int K, int V, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || V < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (K <= 32) return (int)launch_sstats<1>(x, eeb, eet, sstats, D, K, V, s);
  if (K <= 64) return (int)launch_sstats<2>(x, eeb, eet, sstats, D, K, V, s);
  if (K <= 128) return (int)launch_sstats<4>(x, eeb, eet, sstats, D, K, V, s);
  if (K <= 256) return (int)launch_sstats<8>(x, eeb, eet, sstats, D, K, V, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
