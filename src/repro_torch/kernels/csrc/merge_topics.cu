// Weighted topic-statistic merge (the paper's Alg. 1 / Alg. 2) for Hopper.
//
//   out = bias + sum_r w[r] * (stats[r] - base)          stats: n x (K*V)
//
// Replaces the Pallas kernels merge_topics_pallas,
// merge_topics_batched_pallas and merge_topics_ragged_pallas
// (src/repro/kernels/merge_topics/merge_topics.py:37, :66 and :112).
//
// Bound: device memory.  Each output element needs n loads and ~2n flops,
// so the work is (n+1)*K*V*4 bytes over the card's bandwidth.  Every input
// element is read exactly once and every output written once; the running
// sum stays in a register.  K and V are not padded; the flat K*V range is
// masked in the kernel by a grid-stride loop.
//
// The single merge (merge_parts) takes its n parts as n separate arrays:
// up to kMaxParamParts pointers and weights travel by value in the kernel's
// parameters (no device allocation, no host-to-device copy, and no stacked
// copy of the parts); a larger n, or weights that already live on the
// device, are read through device pointers.  Each thread owns two output
// pieces (16-byte float4 when K*V is a multiple of 4 and every pointer is
// 16-byte aligned, else single floats) and issues the loads of a chunk of
// kChunk rows for both before its first FMA, so 2 * kChunk loads are in
// flight per thread instead of one DRAM round trip per row.  The grid is
// the CTAs that fit on the card at once.  The sum order is r = 0 .. n-1,
// so every run gives the same bits.
//
// The segmented form of merge_parts merges several segments of
// consecutive parts in one launch: a device table of R part pointers, R
// weights and n_segments + 1 row offsets, uploaded together; blockIdx.y
// is the segment and writes its own (K, V) result.  The grid is a CTA per
// output tile of each segment (no cap at the resident CTAs): segments of
// 1 and of 32 parts then share the card as the scheduler hands out tiles,
// instead of the short segments' CTAs idling while the long ones stride.
// Each segment's sum order is its rows in order, as in the ragged form
// over a stacked copy, so both give the same bits.
//
// The ragged form gives one program to each (segment, output tile) and
// loops over that segment's rows, read from CSR row offsets
// (n_segments + 1,).  The TPU form relied on grid steps running in order
// to revisit one output block; here no two programs touch the same output,
// so there are no atomics and the sum order (row 0 .. n-1) is the same on
// every run.  The batched form (b merges of n rows each) is the same loop
// with implicit offsets [0, n, 2n, ...]: without an offsets array, segment
// s owns rows [s*n, (s+1)*n).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void merge_vec4(const float4* __restrict__ stats,
                           const float* __restrict__ w,
                           const int* __restrict__ row_offsets,
                           float4* __restrict__ out, int n_rows,
                           long long kv4, float bias, float base) {
  // blockIdx.y is the segment; without offsets each has n_rows rows
  const int seg = blockIdx.y;
  const int r0 = row_offsets ? row_offsets[seg] : seg * n_rows;
  const int r1 = row_offsets ? row_offsets[seg + 1] : r0 + n_rows;
  float4* dst = out + (long long)seg * kv4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < kv4; i += (long long)gridDim.x * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = r0; r < r1; ++r) {
      const float wr = w[r];
      const float4 s = stats[(long long)r * kv4 + i];
      acc.x += wr * (s.x - base);
      acc.y += wr * (s.y - base);
      acc.z += wr * (s.z - base);
      acc.w += wr * (s.w - base);
    }
    dst[i] = make_float4(acc.x + bias, acc.y + bias, acc.z + bias,
                         acc.w + bias);
  }
}

__global__ void merge_scalar(const float* __restrict__ stats,
                             const float* __restrict__ w,
                             const int* __restrict__ row_offsets,
                             float* __restrict__ out, int n_rows,
                             long long kv, float bias, float base) {
  const int seg = blockIdx.y;
  const int r0 = row_offsets ? row_offsets[seg] : seg * n_rows;
  const int r1 = row_offsets ? row_offsets[seg + 1] : r0 + n_rows;
  float* dst = out + (long long)seg * kv;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < kv; i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int r = r0; r < r1; ++r) {
      acc += w[r] * (stats[(long long)r * kv + i] - base);
    }
    dst[i] = acc + bias;
  }
}

constexpr int kMaxParamParts = 128;
constexpr int kChunk = 8;

// The n parts of one merge.  With n <= kMaxParamParts the pointers (and,
// unless w_dev is set, the weights) are the arrays in the struct, 1,560
// bytes of the 4 KB kernel-parameter space; otherwise table points to n
// part pointers on the device.  With seg set, the parts are the table's
// and seg holds the segments' n_segments + 1 row offsets on the device.
struct Parts {
  const float* const* table;  // n part pointers on the device, or null
  const float* w_dev;         // n weights on the device, or null
  const int* seg;             // segment row offsets on the device, or null
  const float* ptr[kMaxParamParts];
  float w[kMaxParamParts];
};

__device__ __forceinline__ void axpy(float4& a, float w, const float4& s,
                                     float base) {
  a.x += w * (s.x - base);
  a.y += w * (s.y - base);
  a.z += w * (s.z - base);
  a.w += w * (s.w - base);
}
__device__ __forceinline__ void axpy(float& a, float w, float s, float base) {
  a += w * (s - base);
}
__device__ __forceinline__ float4 plus(const float4& a, float b) {
  return make_float4(a.x + b, a.y + b, a.z + b, a.w + b);
}
__device__ __forceinline__ float plus(float a, float b) { return a + b; }

// T = float4 or float; CHUNK rows' loads are issued before their FMAs.
// One merge sums rows [0, n) into out; with segments, blockIdx.y = s sums
// rows [seg[s], seg[s + 1]) into out + s * items.
template <typename T, int CHUNK>
__global__ void __launch_bounds__(kThreads)
    merge_parts(const __grid_constant__ Parts p, int n, long long items,
                float bias, float base, T* __restrict__ out) {
  const int r_begin = p.seg ? p.seg[blockIdx.y] : 0;
  const int r_end = p.seg ? p.seg[blockIdx.y + 1] : n;
  out += (long long)blockIdx.y * items;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
       i0 < items; i0 += 2 * stride) {
    const long long i1 = i0 + stride;
    const bool has1 = i1 < items;
    T acc0{}, acc1{};
    for (int r0 = r_begin; r0 < r_end; r0 += CHUNK) {
      T s0[CHUNK], s1[CHUNK];
      float w[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        if (r0 + j < r_end) {
          const T* src = reinterpret_cast<const T*>(
              p.table ? p.table[r0 + j] : p.ptr[r0 + j]);
          w[j] = p.w_dev ? p.w_dev[r0 + j] : p.w[r0 + j];
          s0[j] = __ldg(src + i0);
          if (has1) s1[j] = __ldg(src + i1);
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        if (r0 + j < r_end) {
          axpy(acc0, w[j], s0[j], base);
          if (has1) axpy(acc1, w[j], s1[j], base);
        }
      }
    }
    out[i0] = plus(acc0, bias);
    if (has1) out[i1] = plus(acc1, bias);
  }
}

// CTAs of `kernel` that fit on the current device at once
template <typename K>
int resident_ctas(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

constexpr long long kMaxGridX = 1 << 30;
constexpr int kMaxSegments = 65535;  // gridDim.y

template <typename T>
int launch_parts(const Parts& p, int n, int n_segments, long long items,
                 float bias, float base, T* out, cudaStream_t stream) {
  static const int resident = resident_ctas(merge_parts<T, kChunk>);
  if (resident < 1) return (int)cudaErrorInvalidDevice;
  long long blocks = (items + 2 * kThreads - 1) / (2 * kThreads);
  // one merge: the CTAs that fit at once, striding over the rest;
  // segments: a CTA a tile (see the head of the file)
  if (!p.seg && blocks > resident) blocks = resident;
  if (blocks > kMaxGridX) blocks = kMaxGridX;  // grid-stride covers the rest
  const dim3 grid((unsigned)blocks, (unsigned)n_segments);
  merge_parts<T, kChunk><<<grid, kThreads, 0, stream>>>(p, n, items, bias,
                                                        base, out);
  return (int)cudaGetLastError();
}

// 16-byte loads need kv % 4 == 0 and every pointer 16-byte aligned
bool vec_parts(const void* const* host_ptrs, int n, long long kv,
               const float* out) {
  bool vec = kv % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  for (int r = 0; r < n && vec; ++r)
    vec = reinterpret_cast<std::uintptr_t>(host_ptrs[r]) % 16 == 0;
  return vec;
}

int run_parts(const Parts& p, const void* const* host_ptrs, int n,
              int n_segments, long long kv, float bias, float base,
              float* out, cudaStream_t s) {
  if (vec_parts(host_ptrs, n, kv, out))
    return launch_parts(p, n, n_segments, kv / 4, bias, base,
                        reinterpret_cast<float4*>(out), s);
  return launch_parts(p, n, n_segments, kv, bias, base, out, s);
}

int launch(const float* stats, const float* w, const int* row_offsets,
           float* out, int n_rows, int n_segments, long long kv, float bias,
           float base, cudaStream_t stream) {
  // 16-byte loads need kv % 4 == 0 and 16-byte aligned base pointers
  const bool vec = (kv % 4 == 0) &&
                   (reinterpret_cast<std::uintptr_t>(stats) % 16 == 0) &&
                   (reinterpret_cast<std::uintptr_t>(out) % 16 == 0);
  const long long items = vec ? kv / 4 : kv;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  dim3 grid((unsigned)blocks, (unsigned)n_segments);
  if (vec) {
    merge_vec4<<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(stats), w, row_offsets,
        reinterpret_cast<float4*>(out), n_rows, items, bias, base);
  } else {
    merge_scalar<<<grid, kThreads, 0, stream>>>(stats, w, row_offsets, out,
                                                n_rows, kv, bias, base);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// b merges of n rows each
int mlego_merge_topics_batched(const float* stats, const float* w,
                               float* out, int b, int n, long long kv,
                               float bias, float base, void* stream) {
  return launch(stats, w, nullptr, out, n, b, kv, bias, base,
                (cudaStream_t)stream);
}

int mlego_merge_topics_ragged(const float* stats, const float* w,
                              const int* row_offsets, float* out,
                              int n_segments, long long kv, float bias,
                              float base, void* stream) {
  return launch(stats, w, row_offsets, out, 0, n_segments, kv, bias, base,
                (cudaStream_t)stream);
}

// One merge of n parts.  host_ptrs: the n part pointers (host array);
// host_w: n weights (host array), or null when dev_w is set; dev_table: the
// n part pointers on the device, needed only for n > kMaxParamParts, where
// the weights must be on the device too (dev_w).
int mlego_merge_topics_parts(const void* const* host_ptrs,
                             const float* host_w, const void* dev_table,
                             const float* dev_w, int n, long long kv,
                             float bias, float base, float* out,
                             void* stream) {
  if (n < 1 || kv < 1 || !host_ptrs) return (int)cudaErrorInvalidValue;
  Parts p{};
  p.w_dev = dev_w;
  if (n <= kMaxParamParts) {
    if (!dev_w && !host_w) return (int)cudaErrorInvalidValue;
    for (int r = 0; r < n; ++r) {
      p.ptr[r] = static_cast<const float*>(host_ptrs[r]);
      if (!dev_w) p.w[r] = host_w[r];
    }
  } else {
    if (!dev_table || !dev_w) return (int)cudaErrorInvalidValue;
    p.table = static_cast<const float* const*>(dev_table);
  }
  return run_parts(p, host_ptrs, n, 1, kv, bias, base, out,
                   (cudaStream_t)stream);
}

// Segmented merge of n parts in one launch: segment s merges parts
// [offsets[s], offsets[s + 1]) into out + s * kv.  host_ptrs: the n part
// pointers (host array, read for their alignment); dev_table: the same n
// pointers on the device; dev_w: n weights and dev_offsets: n_segments + 1
// row offsets, on the device.
int mlego_merge_topics_parts_segments(const void* const* host_ptrs,
                                      const void* dev_table,
                                      const float* dev_w,
                                      const int* dev_offsets, int n,
                                      int n_segments, long long kv,
                                      float bias, float base, float* out,
                                      void* stream) {
  if (n < 1 || kv < 1 || n_segments < 1 || n_segments > kMaxSegments ||
      !host_ptrs || !dev_table || !dev_w || !dev_offsets)
    return (int)cudaErrorInvalidValue;
  Parts p{};
  p.table = static_cast<const float* const*>(dev_table);
  p.w_dev = dev_w;
  p.seg = dev_offsets;
  return run_parts(p, host_ptrs, n, n_segments, kv, bias, base, out,
                   (cudaStream_t)stream);
}

const char* mlego_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
