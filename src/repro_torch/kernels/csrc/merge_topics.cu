// Weighted topic-statistic merge (the paper's Alg. 1 / Alg. 2) for Hopper.
//
//   out = bias + sum_r w[r] * (stats[r] - base)          stats: (n, K*V)
//
// Replaces the Pallas kernels merge_topics_pallas and
// merge_topics_ragged_pallas (src/repro/kernels/merge_topics/
// merge_topics.py:37 and :112).
//
// Bound: device memory.  Each output element needs n loads and ~2n flops,
// so the work is (n+1)*K*V*4 bytes over the card's bandwidth.  The design
// reads every input element exactly once, with 16-byte vector loads when
// K*V is a multiple of 4, keeps the running sum in a register and writes
// each output once.  K and V are not padded; the flat K*V range is masked
// in the kernel by a grid-stride loop.
//
// The ragged form gives one program to each (segment, output tile) and
// loops over that segment's rows, read from CSR row offsets
// (n_segments + 1,).  The TPU form relied on grid steps running in order
// to revisit one output block; here no two programs touch the same output,
// so there are no atomics and the sum order (row 0 .. n-1) is the same on
// every run.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void merge_vec4(const float4* __restrict__ stats,
                           const float* __restrict__ w,
                           const int* __restrict__ row_offsets,
                           float4* __restrict__ out, int n_rows,
                           long long kv4, float bias, float base) {
  // blockIdx.y is the segment; without offsets there is one segment
  const int seg = blockIdx.y;
  const int r0 = row_offsets ? row_offsets[seg] : 0;
  const int r1 = row_offsets ? row_offsets[seg + 1] : n_rows;
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
  const int r0 = row_offsets ? row_offsets[seg] : 0;
  const int r1 = row_offsets ? row_offsets[seg + 1] : n_rows;
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

int mlego_merge_topics(const float* stats, const float* w, float* out,
                       int n, long long kv, float bias, float base,
                       void* stream) {
  return launch(stats, w, nullptr, out, n, 1, kv, bias, base,
                (cudaStream_t)stream);
}

int mlego_merge_topics_ragged(const float* stats, const float* w,
                              const int* row_offsets, float* out,
                              int n_segments, long long kv, float bias,
                              float base, void* stream) {
  return launch(stats, w, row_offsets, out, 0, n_segments, kv, bias, base,
                (cudaStream_t)stream);
}

const char* mlego_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
