// Sparse (CSR) LDA variational E-step for Hopper, in two launches.
//
// Replaces the Pallas kernel vb_estep_pallas
// (src/repro/kernels/vb_estep/vb_estep.py:76).  With x (D, V) held as CSR
// rows (indptr, indices, values: nonzero j of document d has term v_j and
// count x_j), eeb = exp(E[log beta]) given transposed as eebT (V, K), and
// gamma0 (D, K), it computes
//
//   repeat n_iters:
//     eet       = exp(psi(gamma) - psi(sum_k gamma))                (D, K)
//     phinorm_j = eet[d] . eeb[:, v_j] + 1e-30              nonzeros of d
//     gamma[d]  = alpha + eet[d] * sum_j (x_j / phinorm_j) eeb[:, v_j]
//   sstats[k, v] = eeb[k, v] * sum_{j in column v} eet[d_j, k] x_j / phinorm_j
//
// which is the TPU kernel's dense E-step: an entry with x = 0 adds exactly
// 0 to gamma and to sstats, so visiting only the nonzeros changes nothing
// but the order of the sums.  psi is the same 8-step shift plus asymptotic
// series (vb_estep.py:29-41), not a library digamma.  Everything is fp32
// with no TF32, so the result stays within 2e-4 of the plain version.
//
// Bound: operations.  Each iteration does 4*K flops per nonzero (phinorm
// and the gamma product) and ~62 per (document, topic) for the digamma
// update; the CSR, eeb, gamma and sstats are a few MB, read or written
// once.  Dense, the same call would be 4*D*K*V flops a iteration, ~140x
// more at the main path's 0.73% nonzeros.
//
// Launch (a), estep_csr_iters: one CTA per document (threads_for(K)
// threads: one per topic and a spare, at least two warps).  The CTA gathers
// its document's rows of eeb, B_j = eebT[v_j, :], into shared memory once
// and runs every iteration from there (eeb does not change within a
// call), so eeb is read from L2 once per document, not once per iteration.
// The rows are stored at a stride S of an odd number of float4s, so
// threads reading rows j, j+1, ... at the same topics hit different banks.
// Per iteration:
//   eet_t = exp(psi(gamma_t) - psi(sum gamma)), one digamma series a
//   thread (the spare thread takes the sum's);
//   phinorm over rows (threads over j, float4 over topics), ratio r_j;
//   the gamma product (thread t sums r_j B_jt over the rows).
// Four __syncthreads an iteration.  The work of a document is a chain of
// short dependent steps, so what keeps the card busy is the number of
// documents in flight: the CTAs stay resident (as many as fit, ~6 an SM at
// K = 100) and take documents from a counter until none is left, with no
// tail wave.  A document with more nonzeros than the row budget R streams
// its rows from L2 in chunks of R every iteration instead (the same code,
// with the gather inside the iteration loop).  It writes gamma, the final
// eet and the final ratios; which CTA takes a document does not change
// its result.
//
// Launch (b), estep_csr_sstats: the TPU kernel adds every doc block into one
// (K, V) output that its grid steps revisit in order.  Here a CTA owns TV
// vocabulary columns, one warp a column: it walks the column's entries (the
// column view: col_ptr and perm, ordered by (v, d)) with lanes over topics,
// adding eet[d, k] * r_j in registers, and multiplies by eeb[k, v] at the
// end.  The (K, TV) block is staged in shared memory so the (K, V) store is
// coalesced.  No atomics and a fixed order: every call gives the same
// bits.  A column with no entries writes exact zeros.
//
// K is not padded in device memory: the kernels take exactly K topics.  In
// shared memory the rows and eet carry zeros up to a multiple of 4 topics,
// which add nothing; threads and k-slots of a template instance beyond K
// are skipped.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreadsA = 288; // threads per CTA, launch (a): K <= 256
// CTAs of launch (a) the compiler sizes its registers for.  Without it
// ptxas gave the kernel 32 registers and spilled; with 4 it takes 56 and
// spills nothing, so 6 CTAs of 128 threads (K = 100) still fit an SM.
constexpr int kMinBlocksA = 4;
constexpr int TV = 32;            // vocabulary columns per CTA, launch (b)
constexpr int kThreadsB = 32 * TV; // one warp per column
constexpr int kMaxSmem = 232448; // bytes of shared memory a CTA may use

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

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Threads of a launch (a) CTA: one per topic and a spare one (which takes
// psi of the sum of gamma), at least two warps.
__host__ __device__ inline int threads_for(int K) {
  const int t = (K + 32) / 32 * 32;
  return t < 64 ? 64 : t;
}

// Row stride of the eeb rows in shared memory: a multiple of 4 floats (rows
// are read as float4) with an odd number of float4s, so eight rows read
// together by a quarter warp fall in different banks.
__host__ __device__ inline int row_stride(int K) {
  const int s = round4(K);
  return (s / 4) % 2 ? s : s + 4;
}

// Floats of shared memory a CTA of launch (a) holds: eet (K), psi of each
// thread's value (threads), gamma (K), the chunk's ratios (R) and R rows of
// B; every part starts on a 16-byte boundary.  (ops.py's estep_plan
// computes the same.)
__host__ __device__ inline int doc_floats(int K, int R) {
  return 2 * round4(K) + round4(threads_for(K)) + round4(R) +
         R * row_stride(K);
}

// Launch (a).  A CTA of threads_for(K) threads per document, thread t < K
// owning topic t; CTAs stay resident and take documents from *next_doc.
__global__ void __launch_bounds__(kMaxThreadsA, kMinBlocksA)
    estep_csr_iters(const int* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const float* __restrict__ values,
                    const float* __restrict__ eebT,
                    const float* __restrict__ gamma0,
                    float* __restrict__ gamma_out,
                    float* __restrict__ eet_out,
                    float* __restrict__ ratio_out, int* __restrict__ next_doc,
                    int D, int K, int R, float alpha, int n_iters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int doc_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nt = blockDim.x;
  const int nw = nt >> 5;
  const int S = row_stride(K);
  const int K4 = round4(K);
  float* e_s = smem;                // [K4]     eet of the document
  float* dg_s = e_s + K4;           // [nt]     psi(gamma_t); psi(sum) last
  float* g_s = dg_s + round4(nt);   // [K4]     gamma
  float* r_s = g_s + K4;            // [R]      ratios of a chunk
  float* b_s = r_s + round4(R);     // [R][S]   eeb rows of a chunk

  // the columns K..S-1 of every row and eet[K..K4-1] stay zero, so the
  // float4 reads past K add nothing
  for (int i = tid; i < R * (S - K); i += nt)
    b_s[(i / (S - K)) * S + K + i % (S - K)] = 0.f;
  if (tid < K4 - K) e_s[K + tid] = 0.f;

  for (;;) {
    __syncthreads();  // the previous document's readers are done
    if (tid == 0) doc_s = atomicAdd(next_doc, 1);
    __syncthreads();
    const int d = doc_s;
    if (d >= D) return;
    const int start = indptr[d];
    const int n = indptr[d + 1] - start;
    const bool resident = n <= R;  // rows loaded in iteration 0 stay
    if (tid < K) g_s[tid] = gamma0[(long long)d * K + tid];
    __syncthreads();

    for (int it = 0;; ++it) {
      const bool last = it == n_iters;
      // eet = exp(psi(g) - psi(sum g)): every warp adds gamma in the same
      // order; thread t < K takes psi(g_t), the last thread psi(sum)
      float sum = 0.f;
      for (int k = lane; k < K; k += 32) sum += g_s[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      dg_s[tid] = digamma_series(tid < K ? g_s[tid] : sum);
      __syncthreads();
      if (tid < K) e_s[tid] = expf(dg_s[tid] - dg_s[nt - 1]);
      __syncthreads();  // e_s visible
      float acc0 = 0.f, acc1 = 0.f;

      for (int c0 = 0; c0 < n; c0 += R) {
        const int m = min(R, n - c0);
        const float* xv = values + start + c0;
        if (!resident || it == 0) {
          const int* idx = indices + start + c0;
          __syncthreads();  // the previous chunk's readers of b_s are done
          // gather: warp w takes rows w, w + nw, ...; each lane fetches
          // one row's term, the warp takes them by shuffle, lanes over
          // topics, the loads of 8 rows issued before their stores
          for (int jb = 0; jb < m; jb += 32 * nw) {
            const int j_mine = jb + lane * nw + warp;
            const int v_mine = j_mine < m ? __ldg(idx + j_mine) : 0;
            const int left = m - jb - warp;
            const int cnt = left <= 0 ? 0 : min(32, (left + nw - 1) / nw);
#pragma unroll 8
            for (int t = 0; t < cnt; ++t) {
              const float* src =
                  eebT + (long long)__shfl_sync(kFull, v_mine, t) * K;
              float* dst = b_s + (jb + t * nw + warp) * S;
              for (int k = lane; k < K; k += 32) dst[k] = __ldg(src + k);
            }
          }
          __syncthreads();
        }

        // phinorm and ratio: threads over rows, float4 over topics
        for (int j = tid; j < m; j += nt) {
          const float4* b = reinterpret_cast<const float4*>(b_s + j * S);
          const float4* e4 = reinterpret_cast<const float4*>(e_s);
          float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int q = 0; q < K4 / 4; ++q) {
            const float4 bb = b[q], ee = e4[q];
            p.x += ee.x * bb.x;
            p.y += ee.y * bb.y;
            p.z += ee.z * bb.z;
            p.w += ee.w * bb.w;
          }
          const float r = __ldg(xv + j) / ((p.x + p.y) + (p.z + p.w) + 1e-30f);
          r_s[j] = r;
          if (last) ratio_out[start + c0 + j] = r;
        }
        if (last) continue;
        __syncthreads();  // every ratio of the chunk is in r_s

        // gamma product: thread t sums r_j B_jt over the rows
        if (tid < K) {
          const float* b = b_s + tid;
          int j = 0;
          for (; j + 3 < m; j += 4) {
            const float4 rr = *reinterpret_cast<const float4*>(r_s + j);
            acc0 += rr.x * b[j * S];
            acc1 += rr.y * b[(j + 1) * S];
            acc0 += rr.z * b[(j + 2) * S];
            acc1 += rr.w * b[(j + 3) * S];
          }
          for (; j < m; ++j) acc0 += r_s[j] * b[j * S];
        }
      }
      if (last) break;
      if (tid < K) g_s[tid] = alpha + e_s[tid] * (acc0 + acc1);
      __syncthreads();  // the new gamma is in g_s
    }

    if (tid < K) {
      gamma_out[(long long)d * K + tid] = g_s[tid];
      eet_out[(long long)d * K + tid] = e_s[tid];
    }
  }
}

// Launch (b).  KS topic slots per lane: K <= 32 * KS; warp c owns column
// v0 + c.
template <int KS>
__global__ void __launch_bounds__(kThreadsB)
    estep_csr_sstats(const int* __restrict__ col_ptr,
                     const int* __restrict__ perm,
                     const int* __restrict__ rows,
                     const float* __restrict__ ratio,
                     const float* __restrict__ eet,
                     const float* __restrict__ eebT,
                     float* __restrict__ sstats, int K, int V) {
  __shared__ float out_s[32 * KS][TV + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int v0 = blockIdx.x * TV;

  const int c = warp;
  const int v = v0 + c;
  if (v < V) {
    const int e0 = col_ptr[v], e1 = col_ptr[v + 1];
    float acc[KS];
#pragma unroll
    for (int s = 0; s < KS; ++s) acc[s] = 0.f;
    for (int eb = e0; eb < e1; eb += 32) {
      // each lane fetches one entry's (document, ratio); the warp then
      // walks them in column order
      int dd = 0;
      float rr = 0.f;
      if (eb + lane < e1) {
        const int p = perm[eb + lane];
        dd = rows[p];
        rr = ratio[p];
      }
      const int cnt = min(32, e1 - eb);
#pragma unroll 8
      for (int t = 0; t < cnt; ++t) {
        const int dt = __shfl_sync(kFull, dd, t);
        const float rt = __shfl_sync(kFull, rr, t);
        const float* row = eet + (long long)dt * K;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int k = lane + 32 * s;
          if (k < K) acc[s] += __ldg(row + k) * rt;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int k = lane + 32 * s;
      if (k < K)
        out_s[k][c] =
            e1 > e0 ? acc[s] * __ldg(eebT + (long long)v * K + k) : 0.f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * TV; i += kThreadsB) {
    const int k = i / TV, c = i - (i / TV) * TV;
    if (v0 + c < V) sstats[(long long)k * V + v0 + c] = out_s[k][c];
  }
}

cudaError_t launch_iters(const int* indptr, const int* indices,
                         const float* values, const float* eebT,
                         const float* gamma0, float* gamma, float* eet,
                         float* ratio, int* next_doc, int D, int K, int R,
                         float alpha, int n_iters, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)doc_floats(K, R);
  const int threads = threads_for(K);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      estep_csr_iters, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(estep_csr_iters,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, estep_csr_iters, threads, smem);
  if (e == cudaSuccess) e = cudaMemsetAsync(next_doc, 0, sizeof(int), stream);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // every CTA that fits at once; each takes documents until none is left
  const int blocks = min(D, sms * per_sm);
  estep_csr_iters<<<blocks, threads, smem, stream>>>(
      indptr, indices, values, eebT, gamma0, gamma, eet, ratio, next_doc, D,
      K, R, alpha, n_iters);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_sstats(const int* col_ptr, const int* perm,
                          const int* rows, const float* ratio,
                          const float* eet, const float* eebT, float* sstats,
                          int K, int V, cudaStream_t stream) {
  const dim3 grid((V + TV - 1) / TV);
  estep_csr_sstats<KS><<<grid, kThreadsB, 0, stream>>>(
      col_ptr, perm, rows, ratio, eet, eebT, sstats, K, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K <= 256, D, V >= 1, n_iters >= 0, R >= 1 (the wrapper checks); ratio
// holds indptr[D] floats; next_doc is one int of scratch.
int mlego_vb_estep_csr_iters(const int* indptr, const int* indices,
                             const float* values, const float* eebT,
                             const float* gamma0, float* gamma, float* eet,
                             float* ratio, int* next_doc, int D, int K, int R,
                             float alpha, int n_iters, void* stream) {
  if (D < 1 || K < 1 || K > 256 || R < 1 || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_iters(indptr, indices, values, eebT, gamma0, gamma, eet,
                           ratio, next_doc, D, K, R, alpha, n_iters,
                           (cudaStream_t)stream);
}

int mlego_vb_estep_csr_sstats(const int* col_ptr, const int* perm,
                              const int* rows, const float* ratio,
                              const float* eet, const float* eebT,
                              float* sstats, int K, int V, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (V < 1 || K < 1) return (int)cudaErrorInvalidValue;
#define SSTATS(KS) \
  (int)launch_sstats<KS>(col_ptr, perm, rows, ratio, eet, eebT, sstats, K, V, s)
  if (K <= 32) return SSTATS(1);
  if (K <= 64) return SSTATS(2);
  if (K <= 128) return SSTATS(4);
  if (K <= 256) return SSTATS(8);
#undef SSTATS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
