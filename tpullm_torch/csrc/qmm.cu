// Fused dequantize×matmul over the v2 plane schema, for Hopper (sm_90a).
//
// Four kernels of y [M, N] = x [M, K] · dequant(planes), for the 22 plane
// formats of qmm_body.cuh (this library: the formats of family
// TPULLM_QMM_FAMILY), all launched where tpullm/ops/pallas/qmm.py::_qmm_2d
// launches its pallas_call:
//
// qmm_kernel and qmm_tc_kernel replace the materializing body _kernel_mat
//   (+ _acc_tile), in two regimes of M that compute the same function with
//   the same rounding points:
//   - M < 16 (decode, the prefill bucket of 8): qmm_kernel, on CUDA cores
//     (qmm_gemv.cuh), TM in {1, 2, 4, 8} rows of x a block. Bound on the
//     card: the plane bytes (2 to 6 bits a weight for the packed formats
//     with their bf16 scales, 8.5 for Q6_K's qw and Q8_0) against 3.35 TB/s.
//     A deep weight stream (a cp.async ring of whole chunks in shared
//     memory); few output columns at decode leave the card idle, so K is
//     split over blockIdx.z into f32 partials that the last block of each
//     column tile sums in split order, in the same launch.
//   - M ≥ 16 (prefill): qmm_tc_kernel, on the tensor cores (qmm_tc.cuh).
//     Bound on the card at M = 512: the tensor-core product, 2·M·K·N against
//     989 TFLOP/s. The design (mma.sync tiles of 128 × 128, two blocks an
//     SM, each weight decoded once per 128 rows of x into shared memory, the
//     minus term as one more tensor-core product on an exact three-way bf16
//     split of the f32 group sums) is in qmm_tc.cuh; K is split as above
//     when the output tiles are too few to fill the card.
//
// qmm_grouped_gemv_kernel and qmm_grouped_tc_kernel replace the
//   group-factored body _kernel, which _qmm_2d takes for the types of
//   GROUPED_TYPES (TPULLM_QMM_GROUPED):
//     y[m, n] = Σ_g scale[g, n] · (Σ_{k∈g} bf16(x[m, k]) · value(k, n))
//               − Σ_g minus_eff[g, n] · (Σ_{k∈g} bf16(x[m, k]))
//   in f32, value the raw code of the identity and bias maps, the table
//   value, or the signed byte (each exact in bf16, so _kernel's bf16 cast
//   of it is the identity here), minus_eff the minus plane or scale·bias.
//   No per-weight scale multiply and rounding: the scale goes on f32 sums
//   once per segment of a group. The same two regimes of M and plans as
//   qmm's, on the same bodies:
//   - M < 16: qmm_grouped_gemv_kernel, the weight stream of qmm_kernel
//     (qmm_gemv.cuh, gemv_grouped_step: each packed row decoded once from
//     the ring, the scale applied once per segment of a group in a 64-slot
//     step), one launch a call.
//   - M ≥ 16: qmm_grouped_tc_kernel, the grouped form of the tensor-core
//     body (qmm_tc.cuh: the unscaled values in the weight tile, each scale
//     segment's products into a fresh fragment scaled once, minus_eff
//     through the split-gsum product); a split K is summed by
//     qmm_reduce_kernel, as qmm_tc_kernel's.

#include "qmm_gemv.cuh"

namespace {

using namespace tpullm;

// The 2-D product below 16 rows: rows m0 .. m0+TM-1 of x [M, K] into out
// [M, N], columns blockIdx.x · 128 .., chunks [blockIdx.z · per, +per).
// With gridDim.z > 1 the blocks of a column tile write partial [split, M, N]
// and the last of them sums it; counters[blockIdx.y · gridDim.x +
// blockIdx.x] is 0 before and after.
template <int TM, int F, bool Grouped>
__device__ __forceinline__ void qmm_gemv_2d(const __nv_bfloat16* __restrict__ x,
                                            const uint8_t* __restrict__ codes,
                                            const uint8_t* __restrict__ qh,
                                            const __nv_bfloat16* __restrict__ scale,
                                            const __nv_bfloat16* __restrict__ minus,
                                            __nv_bfloat16* __restrict__ out,
                                            float* __restrict__ partial,
                                            int* __restrict__ counters, int M, int K, int N,
                                            int chunks_per_split, char* smem) {
  qmm_gemv_body<TM, F, Grouped, true, TM>(x, codes, qh, scale, minus, out, partial, counters,
                                          ContiguousRows{(int)blockIdx.y * TM, M}, M, K, N,
                                          chunks_per_split, smem);
}

template <int TM, int F>
__global__ void __launch_bounds__(kGemvThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
           const uint8_t* __restrict__ qh, const __nv_bfloat16* __restrict__ scale,
           const __nv_bfloat16* __restrict__ minus, __nv_bfloat16* __restrict__ out,
           float* __restrict__ partial, int* __restrict__ counters, int M, int K, int N,
           int chunks_per_split) {
  extern __shared__ __align__(16) char smem[];
  qmm_gemv_2d<TM, F, false>(x, codes, qh, scale, minus, out, partial, counters, M, K, N,
                            chunks_per_split, smem);
}

template <int TM, int F>
__global__ void __launch_bounds__(kGemvThreads)
qmm_grouped_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                        const uint8_t* __restrict__ qh, const __nv_bfloat16* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ minus, __nv_bfloat16* __restrict__ out,
                        float* __restrict__ partial, int* __restrict__ counters, int M, int K,
                        int N, int chunks_per_split) {
  extern __shared__ __align__(16) char smem[];
  qmm_gemv_2d<TM, F, true>(x, codes, qh, scale, minus, out, partial, counters, M, K, N,
                           chunks_per_split, smem);
}

template <int F>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSm)
qmm_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
              const uint8_t* __restrict__ qh, const __nv_bfloat16* __restrict__ scale,
              const __nv_bfloat16* __restrict__ minus, __nv_bfloat16* __restrict__ out,
              float* __restrict__ partial, int M, int K, int N, int chunks_per_split) {
  extern __shared__ __align__(16) char smem[];
  qmm_tc_body<F, false>(x, codes, qh, scale, minus, out, partial, M, K, N, M, 0,
                        blockIdx.x * kTcBM, blockIdx.y * kTcBN, chunks_per_split, smem);
}

template <int F>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSm)
qmm_grouped_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                      const uint8_t* __restrict__ qh, const __nv_bfloat16* __restrict__ scale,
                      const __nv_bfloat16* __restrict__ minus, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ partial, int M, int K, int N, int chunks_per_split) {
  extern __shared__ __align__(16) char smem[];
  qmm_tc_body<F, true>(x, codes, qh, scale, minus, out, partial, M, K, N, M, 0,
                       blockIdx.x * kTcBM, blockIdx.y * kTcBN, chunks_per_split, smem);
}

__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  __nv_bfloat16* __restrict__ out, long long mn, int split) {
  qmm_reduce_body(partial, out, mn, split);
}

// After a launch: the error, else the split reduction when K was split.
int finish(float* partial, __nv_bfloat16* out, int M, int N, int split, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long mn = (long long)M * N;
  qmm_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(partial, out, mn, split);
  return (int)cudaGetLastError();
}

template <int TM, int F, bool Grouped>
inline auto gemv_kernel() {
  if constexpr (Grouped) return qmm_grouped_gemv_kernel<TM, F>;
  else return qmm_kernel<TM, F>;
}

// The launch attributes of a CUDA-core kernel instantiation, set once:
// dynamic shared memory up to its largest x, the whole SM's shared memory
// preferred over L1.
template <int TM, int F, bool Grouped>
cudaError_t gemv_attributes() {
  static const cudaError_t err =
      qmm_tc_attributes(gemv_kernel<TM, F, Grouped>(), gemv_smem_bytes<F>(kGemvXBytes));
  return err;
}

template <int TM, int F, bool Grouped>
int launch_gemv(const void* x, const void* codes, const void* qh, const void* scale,
                const void* minus, void* out, void* partial, void* counters, int M, int K,
                int N, int split, int chunks_per_split, cudaStream_t stream) {
  const int x_bytes = TM * chunks_per_split * kQmmChunk * 2;
  if (x_bytes > kGemvXBytes || (M + TM - 1) / TM > 65535 || split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = gemv_attributes<TM, F, Grouped>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kGemvBN - 1) / kGemvBN, (M + TM - 1) / TM, split);
  auto* kernel = gemv_kernel<TM, F, Grouped>();
  kernel<<<grid, kGemvThreads, gemv_smem_bytes<F>(x_bytes), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(qh), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(minus), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), static_cast<int*>(counters), M, K, N, chunks_per_split);
  return (int)cudaGetLastError();
}

// the tm values match ops/kernels/qmm.py GEMV_TMS
template <int F, bool Grouped>
int launch(const void* x, const void* codes, const void* qh, const void* scale,
           const void* minus, void* out, void* partial, void* counters, int M, int K, int N,
           int tm, int split, int chunks_per_split, cudaStream_t stream) {
  switch (tm) {
#define TPULLM_GEMV_CASE(TM)                                                          \
    case TM: return launch_gemv<TM, F, Grouped>(x, codes, qh, scale, minus, out, partial, \
                                                counters, M, K, N, split,               \
                                                chunks_per_split, stream);
    TPULLM_GEMV_CASE(1) TPULLM_GEMV_CASE(2) TPULLM_GEMV_CASE(4) TPULLM_GEMV_CASE(8)
#undef TPULLM_GEMV_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// grid (M tiles, N tiles, split): the blocks of one weight stripe run
// together, so its planes are read from device memory about once
template <int F, bool Grouped>
int launch_tc(const void* x, const void* codes, const void* qh, const void* scale,
              const void* minus, void* out, void* partial, int M, int K, int N, int split,
              int chunks_per_split, cudaStream_t stream) {
  constexpr int smem = qmm_tc_smem_bytes<F, Grouped>();
  auto* kernel = Grouped ? qmm_grouped_tc_kernel<F> : qmm_tc_kernel<F>;
  const int n_tiles = (N + kTcBN - 1) / kTcBN;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = qmm_tc_attributes(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kTcBM - 1) / kTcBM, n_tiles, split);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(qh), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(minus), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), M, K, N, chunks_per_split);
  return finish(static_cast<float*>(partial), static_cast<__nv_bfloat16*>(out), M, N, split,
                stream);
}

}  // namespace

// The CUDA-core kernel (M < 16), tm in {1, 2, 4, 8}; one launch a call.
// fmt: a tpullm::QmmFmt of this library's family (else cudaErrorInvalidValue).
// qh is read only by the formats with a qh plane, minus only by those with a
// minus plane; the others may be null. With split > 1: partial f32
// [split, M, N] and counters int32 [⌈M/tm⌉ · ⌈N/128⌉], zero before the
// launch and left zero after it (calls on one stream).
extern "C" int tpullm_qmm(int fmt, const void* x, const void* codes, const void* qh,
                          const void* scale, const void* minus, void* out, void* partial,
                          void* counters, int M, int K, int N, int tm, int split,
                          int chunks_per_split, void* stream_ptr) {
  if (!tpullm::qmm_shape_ok(K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (fmt) {
#define TPULLM_QMM_CASE(F) \
    case tpullm::F: return launch<tpullm::F, false>(x, codes, qh, scale, minus, out, partial, counters, M, K, N, tm, split, chunks_per_split, s);
    TPULLM_QMM_FORMATS(TPULLM_QMM_CASE)
#undef TPULLM_QMM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core kernel (M ≥ 16): the arguments of tpullm_qmm less tm;
// with split > 1 a second launch sums partial [split, M, N].
extern "C" int tpullm_qmm_tc(int fmt, const void* x, const void* codes, const void* qh,
                             const void* scale, const void* minus, void* out, void* partial,
                             int M, int K, int N, int split, int chunks_per_split,
                             void* stream_ptr) {
  if (!tpullm::qmm_shape_ok(K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (fmt) {
#define TPULLM_QMM_CASE(F) \
    case tpullm::F: return launch_tc<tpullm::F, false>(x, codes, qh, scale, minus, out, partial, M, K, N, split, chunks_per_split, s);
    TPULLM_QMM_FORMATS(TPULLM_QMM_CASE)
#undef TPULLM_QMM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The group-factored function below 16 rows: the arguments of tpullm_qmm.
extern "C" int tpullm_qmm_grouped(int fmt, const void* x, const void* codes, const void* qh,
                                  const void* scale, const void* minus, void* out,
                                  void* partial, void* counters, int M, int K, int N, int tm,
                                  int split, int chunks_per_split, void* stream_ptr) {
  if (!tpullm::qmm_shape_ok(K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (fmt) {
#define TPULLM_QMM_CASE(F) \
    case tpullm::F: return launch<tpullm::F, true>(x, codes, qh, scale, minus, out, partial, counters, M, K, N, tm, split, chunks_per_split, s);
    TPULLM_QMM_FORMATS(TPULLM_QMM_CASE)
#undef TPULLM_QMM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The group-factored function from 16 rows (tensor cores): the arguments
// of tpullm_qmm_tc.
extern "C" int tpullm_qmm_grouped_tc(int fmt, const void* x, const void* codes, const void* qh,
                                     const void* scale, const void* minus, void* out,
                                     void* partial, int M, int K, int N, int split,
                                     int chunks_per_split, void* stream_ptr) {
  if (!tpullm::qmm_shape_ok(K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (fmt) {
#define TPULLM_QMM_CASE(F) \
    case tpullm::F: return launch_tc<tpullm::F, true>(x, codes, qh, scale, minus, out, partial, M, K, N, split, chunks_per_split, s);
    TPULLM_QMM_FORMATS(TPULLM_QMM_CASE)
#undef TPULLM_QMM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
