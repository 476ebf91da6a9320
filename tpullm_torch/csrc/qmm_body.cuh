// The plane formats' traits that the device bodies of the qmm kernels
// decode through (the gemv body below 16 rows, qmm_gemv.cuh; the
// tensor-core body, qmm_tc.cuh), and the split reduction of the
// tensor-core kernels.
//
// The function is that of tpullm/ops/pallas/qmm.py::_acc_tile:
//
//   y[m, n] = Σ_k bf16(x[m,k]) · bf16(f32(map(code[k,n])) · f32(scale[k/G, n]))
//             − Σ_g (Σ_{k∈g} bf16(x[m,k])) · minus[g, n]
//
// in f32: the weight is rounded to bf16 after the f32 scale multiply and the
// min term is applied through group sums of x. The plane formats are the v2
// schema of ops/qmatmul.py; each is a QmmFormat<F> below: its code layout,
// split unit U, scale group G (16, 32 or 256), map (the identity, a bias
// subtracted from the code, or a code table of 6 or 16 values) and whether
// it has a minus plane. Layouts, for one U-row unit (U = 32 or 256) of a
// [K, N] weight:
//   kHalf    qs [K/2, N]: packed row r holds row r (low nibble) and row
//            r + U/2 (high nibble)                         Q4_0 Q4_1 MXFP4
//                          IQ4_NL (U=32) Q4_K IQ4_XS IQ3_XXS IQ3_S (U=256)
//   kHalfQh  kHalf plus qh [K/8, N]: packed row r holds, in bit j, the fifth
//            bit of row j·U/8 + r               Q5_0 Q5_1 (U=32) Q5_K (U=256)
//   kCrumb   qs [K/4, N]: packed row r holds, in bits 2j..2j+1, row
//            j·U/4 + r                                    Q2_K TQ1_0 TQ2_0
//   kCrumbQh kCrumb plus qh as kHalfQh's, the code lo | hi << 2     Q3_K and
//            the 3-bit codebook codes      IQ2_XXS IQ2_XS IQ2_S IQ1_S IQ1_M
//   kWide    one signed byte per weight, [K, N]          Q6_K (qw), Q8_0 (qs)
//
// A code table sits in shared memory as 16 f32 values, one per bank, so a
// warp's lookups never conflict. A tensor-core kernel whose K is split
// writes f32 partials that qmm_reduce_body sums in split order
// (deterministic, no atomics).
#pragma once

#include "common.cuh"

namespace tpullm {

constexpr int kQmmCols = 4;     // output columns a lane decodes; N is a multiple of it
constexpr int kQmmChunk = 256;  // K rows per chunk

// the format ids the wrappers pass (ops/kernels/qmm.py _FMT)
enum QmmFmt : int {
  kQ4K = 0, kQ6K = 1, kQ5K = 2, kQ8_0 = 3, kQ4_0 = 4, kQ4_1 = 5, kQ5_0 = 6,
  kQ5_1 = 7, kMXFP4 = 8, kIQ4NL = 9, kQ2K = 10, kQ3K = 11, kIQ4XS = 12,
  kIQ2XXS = 13, kIQ2XS = 14, kIQ2S = 15, kIQ3XXS = 16, kIQ3S = 17, kIQ1S = 18,
  kIQ1M = 19, kTQ1_0 = 20, kTQ2_0 = 21
};

enum QmmLayout : int { kHalf, kHalfQh, kCrumb, kCrumbQh, kWide };
// the code tables (ops/qmatmul.py _SCHEMA lut) follow kBias
enum QmmMap : int {
  kIdentity, kBias, kTableMxfp4, kTableIq4nl, kTableIq2, kTableIq3xxs, kTableIq3s, kTableIq1
};

template <int Layout, int U_, int G_, int Map, int Bias, bool Minus>
struct QmmTraits {
  static constexpr int layout = Layout;
  static constexpr int U = U_;      // rows of a split unit
  static constexpr int G = G_;      // rows per scale group
  static constexpr int map = Map;
  static constexpr int bias = Bias;  // subtracted from the code (kBias)
  static constexpr bool has_minus = Minus;
  static constexpr bool has_qh = Layout == kHalfQh || Layout == kCrumbQh;
  static constexpr bool table = Map >= kTableMxfp4;
  // rows of the code plane per weight row: 1, 1/2 or 1/4
  static constexpr int code_div = Layout == kWide ? 1 : (Layout == kHalf || Layout == kHalfQh) ? 2 : 4;
  // elements of each plane for one [K, N] weight (an expert's stride)
  static __host__ __device__ size_t code_elems(int K, int N) { return (size_t)(K / code_div) * N; }
  static __host__ __device__ size_t qh_elems(int K, int N) { return (size_t)(K / 8) * N; }
  static __host__ __device__ size_t scale_elems(int K, int N) { return (size_t)(K / G) * N; }
};

template <int F> struct QmmFormat;
template <> struct QmmFormat<kQ4K> : QmmTraits<kHalf, 256, 32, kIdentity, 0, true> {};
template <> struct QmmFormat<kQ5K> : QmmTraits<kHalfQh, 256, 32, kIdentity, 0, true> {};
template <> struct QmmFormat<kIQ4XS> : QmmTraits<kHalf, 256, 32, kTableIq4nl, 0, false> {};
template <> struct QmmFormat<kQ6K> : QmmTraits<kWide, 256, 16, kIdentity, 0, false> {};  // bias folded
template <> struct QmmFormat<kQ8_0> : QmmTraits<kWide, 32, 32, kIdentity, 0, false> {};
template <> struct QmmFormat<kQ4_0> : QmmTraits<kHalf, 32, 32, kBias, 8, false> {};
template <> struct QmmFormat<kQ4_1> : QmmTraits<kHalf, 32, 32, kIdentity, 0, true> {};
template <> struct QmmFormat<kMXFP4> : QmmTraits<kHalf, 32, 32, kTableMxfp4, 0, false> {};
template <> struct QmmFormat<kIQ4NL> : QmmTraits<kHalf, 32, 32, kTableIq4nl, 0, false> {};
template <> struct QmmFormat<kQ5_0> : QmmTraits<kHalfQh, 32, 32, kBias, 16, false> {};
template <> struct QmmFormat<kQ5_1> : QmmTraits<kHalfQh, 32, 32, kIdentity, 0, true> {};
template <> struct QmmFormat<kQ2K> : QmmTraits<kCrumb, 256, 16, kIdentity, 0, true> {};
template <> struct QmmFormat<kQ3K> : QmmTraits<kCrumbQh, 256, 16, kBias, 4, false> {};
template <> struct QmmFormat<kIQ2XXS> : QmmTraits<kCrumbQh, 256, 32, kTableIq2, 0, false> {};
template <> struct QmmFormat<kIQ2XS> : QmmTraits<kCrumbQh, 256, 16, kTableIq2, 0, false> {};
template <> struct QmmFormat<kIQ2S> : QmmTraits<kCrumbQh, 256, 16, kTableIq2, 0, false> {};
template <> struct QmmFormat<kIQ3XXS> : QmmTraits<kHalf, 256, 32, kTableIq3xxs, 0, false> {};
template <> struct QmmFormat<kIQ3S> : QmmTraits<kHalf, 256, 32, kTableIq3s, 0, false> {};
template <> struct QmmFormat<kIQ1S> : QmmTraits<kCrumbQh, 256, 32, kTableIq1, 0, false> {};
template <> struct QmmFormat<kIQ1M> : QmmTraits<kCrumbQh, 256, 16, kTableIq1, 0, false> {};
template <> struct QmmFormat<kTQ1_0> : QmmTraits<kCrumb, 256, 256, kBias, 1, false> {};
template <> struct QmmFormat<kTQ2_0> : QmmTraits<kCrumb, 256, 256, kBias, 1, false> {};

// The formats one library holds (TPULLM_QMM_FAMILY, set by
// ops/kernels/_build.py: one nvcc per family, all at once). The families
// group formats of one layout and are sized so that no library's compile is
// much longer than the others': the U = 256 half-split formats, whose fully
// unrolled runs are the slowest to compile, one to a library. X(format) for
// each.
#ifndef TPULLM_QMM_FAMILY
#error "TPULLM_QMM_FAMILY must be defined (0..12)"
#elif TPULLM_QMM_FAMILY == 0
#define TPULLM_QMM_FORMATS(X) X(kQ4K)
#elif TPULLM_QMM_FAMILY == 1
#define TPULLM_QMM_FORMATS(X) X(kQ5K)
#elif TPULLM_QMM_FAMILY == 2
#define TPULLM_QMM_FORMATS(X) X(kIQ4XS)
#elif TPULLM_QMM_FAMILY == 3
#define TPULLM_QMM_FORMATS(X) X(kIQ3XXS)
#elif TPULLM_QMM_FAMILY == 4
#define TPULLM_QMM_FORMATS(X) X(kIQ3S)
#elif TPULLM_QMM_FAMILY == 5
#define TPULLM_QMM_FORMATS(X) X(kQ6K) X(kQ8_0)
#elif TPULLM_QMM_FAMILY == 6
#define TPULLM_QMM_FORMATS(X) X(kQ4_0) X(kQ4_1)
#elif TPULLM_QMM_FAMILY == 7
#define TPULLM_QMM_FORMATS(X) X(kMXFP4) X(kIQ4NL)
#elif TPULLM_QMM_FAMILY == 8
#define TPULLM_QMM_FORMATS(X) X(kQ5_0) X(kQ5_1)
#elif TPULLM_QMM_FAMILY == 9
#define TPULLM_QMM_FORMATS(X) X(kQ2K) X(kQ3K)
#elif TPULLM_QMM_FAMILY == 10
#define TPULLM_QMM_FORMATS(X) X(kIQ2XXS) X(kIQ2XS) X(kIQ2S)
#elif TPULLM_QMM_FAMILY == 11
#define TPULLM_QMM_FORMATS(X) X(kIQ1S) X(kIQ1M)
#elif TPULLM_QMM_FAMILY == 12
#define TPULLM_QMM_FORMATS(X) X(kTQ1_0) X(kTQ2_0)
#else
#error "TPULLM_QMM_FAMILY must be 0..12"
#endif

// Threads 0..15 write the format's code table (ops/qmatmul.py _SCHEMA lut)
// into lut, read after a __syncthreads. The 6-entry tables (IQ2, IQ1) are
// padded with their entry 0: a 3-bit code past the table maps to entry 0, as
// the JAX package's where-chain maps it.
template <class P>
__device__ __forceinline__ void qmm_fill_table(float* lut) {
  const int i = threadIdx.x;
  if (i >= 16) return;
  if constexpr (P::map == kTableMxfp4) {
    constexpr float t[16] = {0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12};
    lut[i] = t[i];
  } else if constexpr (P::map == kTableIq4nl) {
    constexpr float t[16] = {-127, -104, -83, -65, -49, -35, -22, -10,
                             1, 13, 25, 38, 53, 69, 89, 113};
    lut[i] = t[i];
  } else if constexpr (P::map == kTableIq2) {
    constexpr float t[16] = {8, 25, 43, -8, -25, -43, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8};
    lut[i] = t[i];
  } else if constexpr (P::map == kTableIq3xxs) {
    constexpr float t[16] = {4, 12, 20, 28, 36, 44, 52, 62,
                             -4, -12, -20, -28, -36, -44, -52, -62};
    lut[i] = t[i];
  } else if constexpr (P::map == kTableIq3s) {
    constexpr float t[16] = {1, 3, 5, 7, 9, 11, 13, 15, -1, -3, -5, -7, -9, -11, -13, -15};
    lut[i] = t[i];
  } else {
    static_assert(P::map == kTableIq1, "a code table");
    constexpr float t[16] = {-0.875f, 0.125f, 1.125f, -1.125f, -0.125f, 0.875f, -0.875f, -0.875f,
                             -0.875f, -0.875f, -0.875f, -0.875f, -0.875f, -0.875f, -0.875f,
                             -0.875f};
    lut[i] = t[i];
  }
}

// map(code) in f32: the code, the code less the bias, or its table value
template <class P>
__device__ __forceinline__ float qmm_value(uint32_t code, const float* lut) {
  if constexpr (P::table) return lut[code];
  else if constexpr (P::map == kBias) return (float)((int)code - P::bias);
  else return (float)code;
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

inline bool qmm_shape_ok(int K, int N) { return K % kQmmChunk == 0 && N % kQmmCols == 0; }

}  // namespace tpullm
