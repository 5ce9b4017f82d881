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
// v and out, far above the card's ridge point, so the products belong on
// the tensor cores.  Two instances, chosen by dtype:
//
// bf16 (flash_fwd_bf16, the serve path): both products on the tensor cores
// with mma.sync.m16n8k16 (bf16 in, f32 accumulate), FlashAttention-2 shape.
//  - one CTA of 4 warps per (q tile, kv head, batch); the G query heads of
//    the kv head are packed as rows (row r <-> position q0 + r / G, head
//    r % G), so each K/V tile serves the whole group.  For hd <= 128 a
//    warp owns two 16-row m-tiles (128 rows a CTA): every K and V fragment
//    it copies out of shared memory by ldmatrix feeds two mma, which halves
//    those copies per mma; at hd = 256 the O fragments of two m-tiles would
//    not fit the registers, so a warp owns one (64 rows a CTA);
//  - Q goes to shared memory once (16-byte cp.async); for hd <= 64 it moves
//    into registers for the whole KV loop (landing in the ring's second
//    stage before that stage is first filled), wider Q is re-read by
//    ldmatrix each tile;
//  - K/V tiles of 64 keys stream through a 2-stage shared-memory ring with
//    16-byte cp.async.cg (rows past S are zero-filled, never read), one
//    __syncthreads a tile; rows are padded by 16 bytes, so ldmatrix (K)
//    and ldmatrix.trans (V) are free of bank conflicts.  At hd = 128 a CTA
//    holds 104 KB and two share an SM;
//  - S = Q K^T accumulates in f32 fragments; the causal, window and
//    ragged-S masks set f32 scores to -inf (tiles that need no mask skip
//    it), and hd^-0.5 is applied in f32 inside the exponent: the online
//    softmax runs on the fragments in f32 with quad shuffles per row, one
//    FFMA and one exp2 a score, p = 2^(s hd^-0.5 log2(e) - m).  A warp
//    rescales O only when a row's max has grown by more than 2^8 (FA4's
//    conditional rescale), which skips most of the 128 multiplies a tile;
//  - P is packed to bf16 in registers straight from the accumulator layout
//    into the A operand of the P.V mma: no shared-memory round trip.
//    Rounding p to bf16 before P.V is what JAX's own _flash_block does
//    (src/repro/models/attention.py:112); inside the 2e-2 bf16 tolerance
//    it is a change of numerics, not of the function.  l sums the f32 p;
//  - the epilogue scales by 1/l and stores bf16 with 16-byte stores
//    through the warp's rows of the ring's first stage;
//  - a 1-D grid with the q tile's rank slowest: blocks are dispatched in
//    order, so all (kv head, batch) pairs' heaviest causal tiles start
//    first and no heavy tile starts late to run alone at the end.
// Rows beyond G * BQ or past S (G = 3, 5; a ragged last tile) stay masked
// through the softmax (m = -1e30, p zeroed) and are never stored.
//
// f32 (flash_fwd_f32, the 1e-5 checks): CUDA-core FMAs in fp32 (TF32
// would break the tolerance); one CTA per (q tile, kv head, batch) with
// 64 packed rows, each thread a 4 x 4 block of scores and a 4 x hd/16
// block of the output from shared memory.
//
// Both: the TPU's sequential innermost KV grid axis is a loop inside the
// CTA; tiles above the causal diagonal and below the window band are never
// visited; the heaviest (last) q tiles are dispatched first; no atomics, so
// every run gives the same bits; the inputs are read in their own
// (B, S, heads, hd) layout (no transpose copy as in the Pallas wrapper).
//
// One step of a sequence-parallel ring (models/attention.py): q_off >= 0
// puts query i at position q_off + i against key j at position j, so the
// masks read q_off + i >= j (causal) and q_off + i - j < window, and the
// visible KV tiles move with the offset; a q tile that sees no key leaves
// its rows at 0.  With lse given, each row's natural log-sum-exp of its
// scaled scores goes to lse (B, S, H) f32 (-inf for a row that saw no
// key) and out is f32 (out_f32), so the ring combines its steps before one
// final cast.  q_off = 0, no lse and a bf16 out give the same launch as
// before.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_ptx.cuh"

namespace {

using namespace mlego;

constexpr int kRows = 64;       // G * BQ query rows of an f32 CTA; the most
                                // query heads a KV head may have
constexpr int kBK = 64;         // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kRescale = 8.f;  // log2 growth of a max that forces a rescale

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;       // 16 rows each
constexpr int kTcThreads = 32 * kWarps;

// bf16 per padded shared-memory row
template <int HD>
__host__ __device__ constexpr int tc_stride() { return HD + 8; }

// 16-row m-tiles a warp owns: two (32 rows) share every K and V fragment
// read from shared memory, which halves those reads per mma; at hd = 256
// the O fragments of two m-tiles would not fit the registers
template <int HD>
__host__ __device__ constexpr int m_tiles() { return HD <= 128 ? 2 : 1; }

// rows of a CTA: 4 warps x 16 x m_tiles
template <int HD>
__host__ __device__ constexpr int tc_rows() {
  return kWarps * 16 * m_tiles<HD>();
}

// Q fragments held in registers for the whole KV loop (hd <= 64); wider
// Q is re-read by ldmatrix each tile
template <int HD>
__host__ __device__ constexpr bool q_in_registers() { return HD <= 64; }

template <int HD>
__host__ __device__ constexpr int tc_smem_bytes() {
  // 2 stages of K and V (64 rows each); Q lands in stage 1 when it moves
  // to registers before that stage is first filled (128 rows fit), and
  // has rows of its own when it stays in shared memory
  return (2 * 2 * kBK + (q_in_registers<HD>() ? 0 : tc_rows<HD>())) *
         tc_stride<HD>() * 2;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, HD <= 64 ? 2 : 1)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, int B, int S, int H,
               int KVH, int G, int BQ, int n_qt,
               long long q_sb, long long q_ss, long long q_sh, long long k_sb,
               long long k_ss, long long k_sh, long long v_sb, long long v_ss,
               long long v_sh, int causal, int window, float scale,
               int q_off, float* __restrict__ lse, int out_f32) {
  constexpr int LD = tc_stride<HD>();
  constexpr int C = HD / 8;           // 16-byte chunks per row
  constexpr int KC = HD / 16;         // k-steps of Q K^T
  constexpr int NT = HD / 8;          // n-tiles of O
  constexpr int MT = m_tiles<HD>();
  constexpr int ROWS = tc_rows<HD>();
  constexpr bool kQReg = q_in_registers<HD>();
  static_assert(!kQReg || ROWS <= 2 * kBK, "Q must fit one ring stage");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s at KVs + s * 2 * kBK * LD: K, then V
  __nv_bfloat16* KVs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Qs = KVs + (kQReg ? 2 : 4) * kBK * LD;

  // 1-D grid, the q tile's rank slowest: every (kv head, batch) pair's
  // heaviest tile is dispatched before any lighter one
  const int n_pairs = KVH * B;
  const int pair = (int)blockIdx.x % n_pairs;
  const int qt = n_qt - 1 - (int)blockIdx.x / n_pairs;
  const int kvh = pair % KVH;
  const int b = pair / KVH;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = qt * BQ;
  const int used = G * BQ;            // rows r = qi * G + g
  const float scale_log2 = scale * kLog2e;

  // the query tile, 16 bytes a copy (idle rows zero-filled)
  for (int idx = tid; idx < ROWS * C; idx += kTcThreads) {
    const int r = idx / C, c = idx - (idx / C) * C;
    const int qi = r / G, g = r - (r / G) * G;
    const bool ok = r < used && q0 + qi < S;
    const __nv_bfloat16* src =
        ok ? q + b * q_sb + (long long)(q0 + qi) * q_ss +
                 (long long)(kvh * G + g) * q_sh + c * 8
           : q;
    cp_async16(Qs + r * LD + c * 8, src, ok);
  }

  // the KV tiles this q tile can see (queries at q_off + q0 ...)
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int n_kt_all = (S + kBK - 1) / kBK;
  const int kt_hi =
      causal ? min((q_off + q_last) / kBK + 1, n_kt_all) : n_kt_all;
  int kt_lo = 0;
  if (window > 0) {
    const int kmin = q_off + q0 - window + 1;
    kt_lo = kmin > 0 ? kmin / kBK : 0;
  }
  const bool idle_rows = used < ROWS || q0 + BQ - 1 > S - 1;

  auto load_kv = [&](int kt, int stage) {
    __nv_bfloat16* Ks = KVs + stage * 2 * kBK * LD;
    __nv_bfloat16* Vs = Ks + kBK * LD;
    const long long kb = b * k_sb + (long long)kvh * k_sh;
    const long long vb = b * v_sb + (long long)kvh * v_sh;
    for (int idx = tid; idx < kBK * C; idx += kTcThreads) {
      const int j = idx / C, c = idx - (idx / C) * C;
      const int key = kt * kBK + j;
      const bool ok = key < S;
      cp_async16(Ks + j * LD + c * 8,
                 ok ? k + kb + (long long)key * k_ss + c * 8 : k, ok);
      cp_async16(Vs + j * LD + c * 8,
                 ok ? v + vb + (long long)key * v_ss + c * 8 : v, ok);
    }
  };

  // this thread's rows: m-tile mt, half h (accumulator layout)
  const int row_base = warp * 16 * MT + (lane >> 2);
  int qpos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_base + mt * 16 + h * 8;
      qpos[mt][h] = (r < used && q0 + r / G < S) ? q_off + q0 + r / G : -1;
    }

  float o[MT][NT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = kNegInf;
      l[mt][h] = 0.f;
    }
  }
  uint32_t qf[kQReg ? MT : 1][kQReg ? KC : 1][4];

  // ldmatrix row addresses of this lane
  const int a_row = warp * 16 * MT + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int kb_row = (lane & 7) + (lane >> 4) * 8;       // K: keys
  const int kb_col = ((lane >> 3) & 1) * 8;              // K: dims
  const int vb_row = (lane & 7) + ((lane >> 3) & 1) * 8; // V: keys
  const int vb_col = (lane >> 4) * 8;                    // V: dims

  const int n_kt = kt_hi - kt_lo;       // <= 0: the tile sees no key
  load_kv(kt_lo, 0);
  cp_async_commit();                    // one group: Q and the first tile
  for (int it = 0; it < n_kt; ++it) {
    const int kt = kt_lo + it;
    const int stage = it & 1;
    cp_async_wait<0>();                 // this tile (and Q) have landed,
    __syncthreads();                    // for all; the other stage is free
    if constexpr (kQReg) {
      if (it == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kc = 0; kc < KC; ++kc)
            ldmatrix_x4(qf[mt][kc],
                        Qs + (a_row + mt * 16) * LD + kc * 16 + a_col);
        __syncthreads();                // Q is read before stage 1 refills
      }
    }
    if (it + 1 < n_kt) {                // the next tile lands during this one
      load_kv(kt + 1, stage ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* Ks = KVs + stage * 2 * kBK * LD;
    const __nv_bfloat16* Vs = Ks + kBK * LD;

    // S = Q K^T: 16 MT rows x 64 keys a warp, f32
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (kQReg) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kc][e];
        } else {
          ldmatrix_x4(a[mt], Qs + (a_row + mt * 16) * LD + kc * 16 + a_col);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Ks + (np * 16 + kb_row) * LD + kc * 16 + kb_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // mask the f32 scores (-inf), then the online softmax in the log2
    // domain: p = 2^(s hd^-0.5 log2(e) - m), one FFMA and one exp2 a
    // score.  m starts at -1e30, so a row with every score masked keeps
    // m = -1e30 and gets p = 2^-inf = 0, coef = 1, with no test
    const int k0 = kt * kBK;
    const bool need_mask = idle_rows || k0 + kBK > S ||
                           (causal && k0 + kBK - 1 > q_off + q0) ||
                           (window > 0 && q_off + q_last - k0 >= window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (need_mask) {
            const int qp = qpos[mt][e >> 1];
            const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
            bool ok = qp >= 0 && key < S;
            if (causal) ok = ok && key <= qp;
            if (window > 0) ok = ok && qp - key < window;
            if (!ok) s[mt][n][e] = -INFINITY;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
        }
      }
      // the running max moves only when some row of the warp has grown by
      // more than kRescale (else p <= 2^kRescale against the stale max,
      // and the O rescale is skipped): softmax does not depend on the m it
      // subtracts, so this changes rounding only
      bool grow = false;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1)
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
        mx[h] *= scale_log2;
        grow = grow || mx[h] > m[mt][h] + kRescale;
      }
      float mneg[2], sum[2] = {0.f, 0.f};
      if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mn = fmaxf(m[mt][h], mx[h]);
          const float coef = exp2f(m[mt][h] - mn);
          m[mt][h] = mn;
          l[mt][h] *= coef;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            o[mt][n][2 * h] *= coef;
            o[mt][n][2 * h + 1] *= coef;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) mneg[h] = -m[mt][h];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              exp2f(fmaf(s[mt][n][e], scale_log2, mneg[e >> 1]));
          s[mt][n][e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[mt][h] += sum[h];
    }

    // O += P V: P from the score fragments, rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vs + (kk * 16 + vb_row) * LD + dp * 16 +
                                  vb_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], a[mt], bv[0], bv[1]);
          mma_bf16(o[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();                   // a tile that saw no key: Q's copy
  __syncthreads();                      // stage 0 is free for the output

  // epilogue: 1/l, bf16 into the warp's rows of stage 0, 16-byte stores
  // (f32 out and lse: straight from the registers)
  __nv_bfloat16* Os = KVs;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[mt][h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, off);
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      if (out_f32) {
        const int r = row_base + mt * 16 + h * 8;
        const int qi = r / G;
        if (r < used && q0 + qi < S) {
          const long long row_off =
              ((long long)b * S + q0 + qi) * H + kvh * G + (r - qi * G);
          float* dst = reinterpret_cast<float*>(out) + row_off * HD;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            *reinterpret_cast<float2*>(dst + n * 8 + (lane & 3) * 2) =
                make_float2(o[mt][n][2 * h] * inv,
                            o[mt][n][2 * h + 1] * inv);
          if (lse != nullptr && (lane & 3) == 0)
            lse[row_off] = lt > 0.f ? (m[mt][h] + log2f(lt)) * kLn2
                                    : -INFINITY;
        }
        continue;
      }
      uint32_t* row = reinterpret_cast<uint32_t*>(
          Os + (row_base + mt * 16 + h * 8) * LD);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        row[n * 4 + (lane & 3)] =
            pack_bf16(o[mt][n][2 * h] * inv, o[mt][n][2 * h + 1] * inv);
    }
  }
  if (out_f32) return;
  __syncwarp();
  for (int idx = lane; idx < 16 * MT * C; idx += 32) {
    const int r = warp * 16 * MT + idx / C, c = idx - (idx / C) * C;
    const int qi = r / G;
    if (r >= used || q0 + qi >= S) continue;
    const int h = kvh * G + (r - qi * G);
    *reinterpret_cast<uint4*>(out + (((long long)b * S + q0 + qi) * H + h) *
                                        HD + c * 8) =
        *reinterpret_cast<const uint4*>(Os + r * LD + c * 8);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int S, int H, int KVH, const long long* st, int causal,
                int window, float scale, int q_off, float* lse, int out_f32,
                cudaStream_t stream) {
  const int G = H / KVH;
  const int BQ = tc_rows<HD>() / G;
  const int bytes = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + BQ - 1) / BQ;
  flash_fwd_bf16<HD><<<(unsigned)(n_qt * KVH * B), kTcThreads, bytes,
                       stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      B, S, H, KVH, G, BQ, n_qt, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, scale, q_off, lse, out_f32);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;   // 16 x 16

template <int HD>
constexpr int smem_floats() {
  return kRows * (HD + 1) + kBK * (HD + 1) + kBK * HD + kRows * (kBK + 1);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int S,
              int H, int G, int BQ, long long q_sb, long long q_ss,
              long long q_sh, long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh, int causal,
              int window, float scale, int q_off, float* __restrict__ lse) {
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

  // the query tile, scaled
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - (idx / HD) * HD;
    const int qi = r / G, g = r - (r / G) * G;
    float x = 0.f;
    if (r < used && q0 + qi < S) {
      x = q[b * q_sb + (long long)(q0 + qi) * q_ss +
            (long long)(kvh * G + g) * q_sh + d] * scale;
    }
    Qs[r * (HD + 1) + d] = x;
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int p = q0 + r / G;
    qpos[i] = (r < used && p < S) ? q_off + p : -1;   // -1: an idle row
  }
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // the KV tiles this q tile can see (queries at q_off + q0 ...)
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int n_kt_all = (S + kBK - 1) / kBK;
  const int kt_hi =
      causal ? min((q_off + q_last) / kBK + 1, n_kt_all) : n_kt_all;
  int kt_lo = 0;
  if (window > 0) {
    const int kmin = q_off + q0 - window + 1;
    kt_lo = kmin > 0 ? kmin / kBK : 0;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // the last tile's Ks/Vs/Ps are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx - (idx / HD) * HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < S) {
        kx = k[b * k_sb + (long long)(k0 + j) * k_ss +
               (long long)kvh * k_sh + d];
        vx = v[b * v_sb + (long long)(k0 + j) * v_ss +
               (long long)kvh * v_sh + d];
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
    const long long row_off = ((long long)b * S + qpos[i] - q_off) * H + h;
    float* dst = out + row_off * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = acc[i][j] * inv;
    if (lse != nullptr && tx == 0)
      lse[row_off] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int KVH, const long long* st, int causal,
               int window, float scale, int q_off, float* lse, int /*out_f32*/,
               cudaStream_t stream) {
  const int G = H / KVH;
  const int BQ = kRows / G;
  const int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)KVH, (unsigned)B);
  flash_fwd_f32<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, G, BQ,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, scale, q_off, lse);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, void*, int, int,
                       int, int, const long long*, int, int, float, int,
                       float*, int, cudaStream_t);

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

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  strides
// (in elements) of q, k, v: {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
// v_ss, v_sh}; the head_dim stride is 1.  Needs H % KVH == 0 and
// H / KVH <= 64; bf16 also needs q, k, v 16-byte aligned and every stride a
// multiple of 8 elements (16-byte copies).  q_off >= 0 is the position of
// query 0 against key 0 (a ring step); lse (B, S, H) f32 or null; out is
// f32 when lse is given (or dtype is 0), else bf16.
int mlego_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int dtype, int B, int S, int H, int KVH,
                          int hd, long long q_sb, long long q_ss,
                          long long q_sh, long long k_sb, long long k_ss,
                          long long k_sh, long long v_sb, long long v_ss,
                          long long v_sh, int causal, int window, float scale,
                          int q_off, float* lse, void* stream) {
  if (KVH < 1 || H % KVH != 0 || H / KVH > kRows || S < 1 || B < 1 ||
      q_off < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                           k_sh, v_sb, v_ss, v_sh};
  if (dtype == 1) {
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                           (uintptr_t)out;
    long long strides = 0;
    for (long long s : st) strides |= s;
    if ((ptrs & 15) != 0 || (strides & 7) != 0)
      return (int)cudaErrorMisalignedAddress;
  }
  const Launch fn = pick(dtype, hd);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, out, B, S, H, KVH, st, causal, window, scale, q_off,
            lse, lse != nullptr ? 1 : 0, (cudaStream_t)stream);
}

}  // extern "C"
