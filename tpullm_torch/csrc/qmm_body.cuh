// The dequantize×matmul device body shared by the qmm kernels (qmm.cu: one
// weight; qmm_moe.cu: expert stacks and expert gathers).
//
// It is the arithmetic of tpullm/ops/pallas/qmm.py::_acc_tile. For rows
// m0 .. m0+TM-1 of x [M, K] and 512 output columns it computes
//
//   y[m, n] = Σ_k bf16(x[m,k]) · bf16(f32(value[k,n]) · f32(scale[k/G, n]))
//             − Σ_g (Σ_{k∈g} bf16(x[m,k])) · minus[g, n]
//
// in f32: the weight is rounded to bf16 after the f32 scale multiply and the
// min term is applied through group sums of x. Plane formats (the v2 schema
// of ops/qmatmul.py), by template parameter F:
//   kQ4K  qs [K/2, N] half-split nibbles, scale + minus [K/32, N]
//   kQ5K  as kQ4K plus qh [K/8, N]: packed row r of a 256-row chunk holds,
//         in bit j, the fifth bit of row j·32 + r
//   kQ6K  qw [K, N] signed bytes (bias folded), scale [K/16, N]
//   kQ8_0 qs [K, N] signed bytes, scale [K/32, N]
//
// Layout of the work: each thread owns 4 neighbouring output columns, so a
// warp reads 128 contiguous plane bytes per row; a block stages a 256-row
// chunk of x (one K-quant superblock) in shared memory as f32 and keeps TM
// rows of partial sums in registers. A block covers chunks
// [blockIdx.z · per, (blockIdx.z + 1) · per); with more than one split it
// writes f32 partials that qmm_reduce sums in split order (deterministic,
// no atomics).
#pragma once

#include "common.cuh"

namespace tpullm {

constexpr int kQmmThreads = 128;                 // threads per block
constexpr int kQmmCols = 4;                      // output columns per thread
constexpr int kQmmBlockN = kQmmThreads * kQmmCols;  // 512 columns per block
constexpr int kQmmChunk = 256;                   // K rows per chunk (the split unit U)

enum QmmFmt : int { kQ4K = 0, kQ6K = 1, kQ5K = 2, kQ8_0 = 3 };

template <int F>
struct QmmPlanes {
  static constexpr bool wide = F == kQ6K || F == kQ8_0;  // one signed byte per weight
  static constexpr int G = F == kQ6K ? 16 : 32;           // rows per scale group
  static constexpr bool has_minus = F == kQ4K || F == kQ5K;
  static constexpr bool has_qh = F == kQ5K;
  // elements of each plane for one [K, N] weight (an expert's stride)
  static __host__ __device__ size_t code_elems(int K, int N) {
    return (size_t)(wide ? K : K / 2) * N;
  }
  static __host__ __device__ size_t qh_elems(int K, int N) { return (size_t)(K / 8) * N; }
  static __host__ __device__ size_t scale_elems(int K, int N) { return (size_t)(K / G) * N; }
};

// Stores one block's TM rows × 4 columns: to out [R, N] as bf16 when the K
// range is not split, else to partial [split, R, N] as f32. Row m of the
// block is row row0 + m0 + m of the R output rows.
template <int TM>
__device__ __forceinline__ void qmm_store(const float (&acc)[TM][kQmmCols],
                                          __nv_bfloat16* __restrict__ out,
                                          float* __restrict__ partial, int M, int N,
                                          int R, int row0, int m0, int n0) {
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    if (m0 + m >= M) break;
    const size_t row = (size_t)row0 + m0 + m;
    if (gridDim.z == 1) {
      __nv_bfloat16* o = out + row * N + n0;
#pragma unroll
      for (int j = 0; j < kQmmCols; ++j) o[j] = __float2bfloat16_rn(acc[m][j]);
    } else {
      float* o = partial + ((size_t)blockIdx.z * R + row) * N + n0;
#pragma unroll
      for (int j = 0; j < kQmmCols; ++j) o[j] = acc[m][j];
    }
  }
}

// x, codes, qh, scale and minus point at this block's weight and input rows;
// the block computes rows m0 .. m0+TM-1 of x [M, K] into output rows
// row0 + m0 .. of R, for the 512 columns of blockIdx.x.
template <int TM, int F>
__device__ __forceinline__ void qmm_body(const __nv_bfloat16* __restrict__ x,
                                         const uint8_t* __restrict__ codes,
                                         const uint8_t* __restrict__ qh,
                                         const __nv_bfloat16* __restrict__ scale,
                                         const __nv_bfloat16* __restrict__ minus,
                                         __nv_bfloat16* __restrict__ out,
                                         float* __restrict__ partial, int M, int K, int N,
                                         int R, int row0, int m0, int chunks_per_split) {
  using P = QmmPlanes<F>;
  constexpr int G = P::G;
  constexpr int NG = kQmmChunk / G;  // scale groups per chunk
  __shared__ float xs[TM][kQmmChunk];
  __shared__ float gsum[TM][P::has_minus ? NG : 1];

  const int n0 = (blockIdx.x * kQmmThreads + threadIdx.x) * kQmmCols;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(K / kQmmChunk, c_begin + chunks_per_split);
  const bool active = n0 < N;  // N % 4 == 0: a thread's 4 columns are all in range

  float acc[TM][kQmmCols];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < kQmmCols; ++j) acc[m][j] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int k0 = c * kQmmChunk;
    __syncthreads();  // the previous chunk's readers are done with xs
    for (int i = threadIdx.x; i < TM * kQmmChunk; i += kQmmThreads) {
      const int m = i / kQmmChunk, kk = i % kQmmChunk;
      xs[m][kk] = (m0 + m < M) ? __bfloat162float(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if constexpr (P::has_minus) {
      for (int i = threadIdx.x; i < TM * NG; i += kQmmThreads) {
        const int m = i / NG, g = i % NG;
        float s = 0.f;
        for (int j = 0; j < G; ++j) s += xs[m][g * G + j];
        gsum[m][g] = s;
      }
      __syncthreads();
    }
    if (!active) continue;

    if constexpr (P::wide) {
      // one signed byte per weight (Q6_K: bias folded at repack)
      for (int g = 0; g < NG; ++g) {
        float sc[kQmmCols];
        load_bf16x4(scale + (size_t)(k0 / G + g) * N + n0, sc);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const int kk = g * G + r;
          const uint32_t q = *reinterpret_cast<const uint32_t*>(codes + (size_t)(k0 + kk) * N + n0);
          float w[kQmmCols];
#pragma unroll
          for (int j = 0; j < kQmmCols; ++j)
            w[j] = bf16_round((float)(int8_t)((q >> (8 * j)) & 0xffu) * sc[j]);
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            const float xv = xs[m][kk];
#pragma unroll
            for (int j = 0; j < kQmmCols; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
          }
        }
      }
    } else {
      // half-split unit 256: packed row rr (0..127) of the chunk holds code
      // k0 + rr in its low nibble and code k0 + 128 + rr in its high nibble;
      // Q5_K's fifth bits of both sit in qh row rr % 32, bits rr/32 and rr/32 + 4
      for (int g = 0; g < 4; ++g) {
        float s_lo[kQmmCols], s_hi[kQmmCols];
        load_bf16x4(scale + (size_t)(k0 / G + g) * N + n0, s_lo);
        load_bf16x4(scale + (size_t)(k0 / G + 4 + g) * N + n0, s_hi);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const int rr = g * G + r;
          const uint32_t q = *reinterpret_cast<const uint32_t*>(codes + (size_t)(k0 / 2 + rr) * N + n0);
          uint32_t h = 0;
          if constexpr (P::has_qh) h = *reinterpret_cast<const uint32_t*>(qh + (size_t)(k0 / 8 + r) * N + n0);
          float w_lo[kQmmCols], w_hi[kQmmCols];
#pragma unroll
          for (int j = 0; j < kQmmCols; ++j) {
            const uint32_t byte = (q >> (8 * j)) & 0xffu;
            uint32_t lo = byte & 0xfu, hi = byte >> 4;
            if constexpr (P::has_qh) {
              const uint32_t hb = (h >> (8 * j)) & 0xffu;
              lo |= ((hb >> g) & 1u) << 4;
              hi |= ((hb >> (g + 4)) & 1u) << 4;
            }
            w_lo[j] = bf16_round((float)lo * s_lo[j]);
            w_hi[j] = bf16_round((float)hi * s_hi[j]);
          }
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            const float x_lo = xs[m][rr], x_hi = xs[m][rr + kQmmChunk / 2];
#pragma unroll
            for (int j = 0; j < kQmmCols; ++j) {
              acc[m][j] = fmaf(x_lo, w_lo[j], acc[m][j]);
              acc[m][j] = fmaf(x_hi, w_hi[j], acc[m][j]);
            }
          }
        }
      }
    }
    if constexpr (P::has_minus) {
      // the min term through group sums of x
      for (int g = 0; g < NG; ++g) {
        float mn[kQmmCols];
        load_bf16x4(minus + (size_t)(k0 / G + g) * N + n0, mn);
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int j = 0; j < kQmmCols; ++j) acc[m][j] = fmaf(-gsum[m][g], mn[j], acc[m][j]);
      }
    }
  }

  if (!active) return;
  qmm_store<TM>(acc, out, partial, M, N, R, row0, m0, n0);
}

// Sums the K-split partials [split, mn] in split order and rounds to bf16.
__device__ __forceinline__ void qmm_reduce_body(const float* __restrict__ partial,
                                                __nv_bfloat16* __restrict__ out,
                                                long long mn, int split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < split; ++z) s += partial[(size_t)z * mn + i];
  out[i] = __float2bfloat16_rn(s);
}

// The launch shape shared by the three entries: grid (N/512, rows, split).
inline dim3 qmm_grid(int N, int y_blocks, int split) {
  return dim3((N + kQmmBlockN - 1) / kQmmBlockN, y_blocks, split);
}

inline bool qmm_shape_ok(int K, int N) { return K % kQmmChunk == 0 && N % kQmmCols == 0; }

}  // namespace tpullm
