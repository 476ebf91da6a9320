// Fused dequantize×matmul over the v2 plane schema, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpullm/ops/pallas/qmm.py::_kernel_mat (+ _acc_tile),
// launched by _qmm_2d. Computes, for every M:
//
//   y[m, n] = Σ_k bf16(x[m,k]) · bf16(f32(code[k,n]) · f32(scale[k/G, n]))
//             − Σ_g (Σ_{k∈g} bf16(x[m,k])) · minus[g, n]
//
// in f32, output bf16: the rounding points of _acc_tile (the weight is
// rounded to bf16 after the f32 scale multiply; the min term is applied
// through group sums of x).
//
// What bounds it on the card: at decode (M = 1) the plane bytes (≈4.5 bits a
// weight for Q4_K, 8.5 for the wide Q6_K) against 3.35 TB/s; at prefill the
// CUDA-core FMAs (no tensor cores yet). Design: each thread owns 4
// neighbouring output columns, so a warp reads 128 contiguous plane bytes per
// row; a block stages a 256-row chunk of x (one K-quant superblock) in shared
// memory as f32 and keeps TM rows of partial sums in registers. Few output
// columns at decode leave the card idle, so K is split over blockIdx.z into
// f32 partials that a second pass sums in a fixed order (deterministic, no
// atomics).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;              // threads per block
constexpr int kCols = 4;                   // output columns per thread
constexpr int kBlockN = kThreads * kCols;  // 512 columns per block
constexpr int kChunk = 256;                // K rows per chunk (the split unit U)

template <int TM, bool kWide>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x,      // [M, K]
           const uint8_t* __restrict__ codes,         // Q4_K qs [K/2, N]; Q6_K qw [K, N]
           const __nv_bfloat16* __restrict__ scale,   // [K/G, N]
           const __nv_bfloat16* __restrict__ minus,   // Q4_K [K/32, N]; unused for Q6_K
           __nv_bfloat16* __restrict__ out,           // [M, N] when gridDim.z == 1
           float* __restrict__ partial,               // [gridDim.z, M, N] otherwise
           int M, int K, int N, int chunks_per_split) {
  constexpr int G = kWide ? 16 : 32;
  constexpr int NG = kChunk / G;  // scale groups per chunk
  __shared__ float xs[TM][kChunk];
  __shared__ float gsum[TM][kWide ? 1 : NG];

  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int m0 = blockIdx.y * TM;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(K / kChunk, c_begin + chunks_per_split);
  const bool active = n0 < N;  // N % 4 == 0: a thread's 4 columns are all in range

  float acc[TM][kCols];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int k0 = c * kChunk;
    __syncthreads();  // the previous chunk's readers are done with xs
    for (int i = threadIdx.x; i < TM * kChunk; i += kThreads) {
      const int m = i / kChunk, kk = i % kChunk;
      xs[m][kk] = (m0 + m < M) ? __bfloat162float(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (!kWide) {
      for (int i = threadIdx.x; i < TM * NG; i += kThreads) {
        const int m = i / NG, g = i % NG;
        float s = 0.f;
        for (int j = 0; j < G; ++j) s += xs[m][g * G + j];
        gsum[m][g] = s;
      }
      __syncthreads();
    }
    if (!active) continue;

    if (kWide) {
      // qw: one signed byte per weight, bias folded at repack
      for (int g = 0; g < NG; ++g) {
        float sc[kCols];
        tpullm::load_bf16x4(scale + (size_t)(k0 / G + g) * N + n0, sc);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const int kk = g * G + r;
          const uint32_t q = *reinterpret_cast<const uint32_t*>(codes + (size_t)(k0 + kk) * N + n0);
          float w[kCols];
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            w[j] = tpullm::bf16_round((float)(int8_t)((q >> (8 * j)) & 0xffu) * sc[j]);
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            const float xv = xs[m][kk];
#pragma unroll
            for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
          }
        }
      }
    } else {
      // half-split unit 256: packed row r (0..127) of the chunk holds code
      // k0 + r in its low nibble and code k0 + 128 + r in its high nibble
      for (int g = 0; g < 4; ++g) {
        float s_lo[kCols], s_hi[kCols];
        tpullm::load_bf16x4(scale + (size_t)(k0 / G + g) * N + n0, s_lo);
        tpullm::load_bf16x4(scale + (size_t)(k0 / G + 4 + g) * N + n0, s_hi);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const int rr = g * G + r;
          const uint32_t q = *reinterpret_cast<const uint32_t*>(codes + (size_t)(k0 / 2 + rr) * N + n0);
          float w_lo[kCols], w_hi[kCols];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const uint32_t byte = (q >> (8 * j)) & 0xffu;
            w_lo[j] = tpullm::bf16_round((float)(byte & 0xfu) * s_lo[j]);
            w_hi[j] = tpullm::bf16_round((float)(byte >> 4) * s_hi[j]);
          }
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            const float x_lo = xs[m][rr], x_hi = xs[m][rr + kChunk / 2];
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              acc[m][j] = fmaf(x_lo, w_lo[j], acc[m][j]);
              acc[m][j] = fmaf(x_hi, w_hi[j], acc[m][j]);
            }
          }
        }
      }
      // the min term through group sums of x
      for (int g = 0; g < NG; ++g) {
        float mn[kCols];
        tpullm::load_bf16x4(minus + (size_t)(k0 / G + g) * N + n0, mn);
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(-gsum[m][g], mn[j], acc[m][j]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    if (m0 + m >= M) break;
    if (gridDim.z == 1) {
      __nv_bfloat16* o = out + (size_t)(m0 + m) * N + n0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) o[j] = __float2bfloat16_rn(acc[m][j]);
    } else {
      float* o = partial + ((size_t)blockIdx.z * M + m0 + m) * N + n0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) o[j] = acc[m][j];
    }
  }
}

// Sums the K-split partials in split order and rounds to bf16.
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  __nv_bfloat16* __restrict__ out,
                                  long long mn, int split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < split; ++z) s += partial[(size_t)z * mn + i];
  out[i] = __float2bfloat16_rn(s);
}

template <int TM, bool kWide>
void launch_tm(const void* x, const void* codes, const void* scale, const void* minus,
               void* out, void* partial, int M, int K, int N, int split,
               int chunks_per_split, cudaStream_t stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + TM - 1) / TM, split);
  qmm_kernel<TM, kWide><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(minus),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial), M, K, N,
      chunks_per_split);
}

template <bool kWide>
int launch(const void* x, const void* codes, const void* scale, const void* minus,
           void* out, void* partial, int M, int K, int N, int tm, int split,
           int chunks_per_split, void* stream_ptr) {
  if (K % kChunk != 0 || N % kCols != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (tm) {
    case 1: launch_tm<1, kWide>(x, codes, scale, minus, out, partial, M, K, N, split, chunks_per_split, stream); break;
    case 2: launch_tm<2, kWide>(x, codes, scale, minus, out, partial, M, K, N, split, chunks_per_split, stream); break;
    case 4: launch_tm<4, kWide>(x, codes, scale, minus, out, partial, M, K, N, split, chunks_per_split, stream); break;
    case 8: launch_tm<8, kWide>(x, codes, scale, minus, out, partial, M, K, N, split, chunks_per_split, stream); break;
    case 16: launch_tm<16, kWide>(x, codes, scale, minus, out, partial, M, K, N, split, chunks_per_split, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long mn = (long long)M * N;
  qmm_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out), mn, split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tpullm_qmm_q4k(const void* x, const void* qs, const void* scale,
                              const void* minus, void* out, void* partial, int M,
                              int K, int N, int tm, int split, int chunks_per_split,
                              void* stream) {
  return launch<false>(x, qs, scale, minus, out, partial, M, K, N, tm, split,
                       chunks_per_split, stream);
}

extern "C" int tpullm_qmm_q6k(const void* x, const void* qw, const void* scale,
                              void* out, void* partial, int M, int K, int N, int tm,
                              int split, int chunks_per_split, void* stream) {
  return launch<true>(x, qw, scale, nullptr, out, partial, M, K, N, tm, split,
                      chunks_per_split, stream);
}
