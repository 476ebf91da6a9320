// Fused dequantize×matmul over packed MoE expert stacks (planes [E, rows, N]),
// for Hopper (sm_90a). Two kernels with the rounding points of
// tpullm/ops/pallas/qmm.py::_acc_tile, for the 22 plane formats of
// qmm_body.cuh (this library: family TPULLM_QMM_FAMILY):
//
// qmm_stack_kernel replaces tpullm/ops/pallas/qmm.py::_kernel_stack (launched
//   by _qmm_stack): out[e] = x(e) · dequant(W[e]) for every expert, x shared
//   [M, K] (expert stride 0) or per expert [E, M, K]; out [E, M, N]. It runs
//   on the tensor-core body of qmm_tc.cuh, the one qmm's M ≥ 16 regime uses:
//   blockIdx.y walks (expert, column tile), an expert's planes offset by the
//   QmmTraits *_elems helpers. Bound on the card: at the MoE prefill (M ≥ 32
//   tokens, all 8 experts) the tensor-core product, 2·E·M·K·N against 989
//   TFLOP/s. The main path calls it only there (the gather takes every
//   forward of B·T ≤ 16 rows), so it has no CUDA-core regime: a smaller M
//   runs on the same tiles, its rows past M read as 0.
//
// qmm_gather_kernel replaces tpullm/ops/pallas/qmm.py::_kernel_gather
//   (launched by _qmm_gather): out[t] = x[t] · dequant(W[ids[t]]), one block
//   row per token slot. Where the TPU prefetched ids as scalars to pick the
//   plane blocks, each block here loads its own ids[t] from device memory,
//   so the host never reads the routing. Bound on the card: the routed
//   experts' plane bytes (decode: 2 slots per token) against 3.35 TB/s; K is
//   split over blockIdx.z, as in qmm.cu, so the few column blocks of a
//   2-slot gather still fill the card.

#include "qmm_tc.cuh"

namespace {

using namespace tpullm;

template <int F>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSm)
qmm_stack_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                 const uint8_t* __restrict__ qh, const __nv_bfloat16* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ minus, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ partial, int M, int K, int N, int E, int n_tiles,
                 long long x_stride, int chunks_per_split) {
  using P = QmmFormat<F>;
  extern __shared__ __align__(16) char smem[];
  const int e = blockIdx.y / n_tiles;
  qmm_tc_body<F>(x + (size_t)e * x_stride, codes + e * P::code_elems(K, N),
                 P::has_qh ? qh + e * P::qh_elems(K, N) : nullptr,
                 scale + e * P::scale_elems(K, N),
                 P::has_minus ? minus + e * P::scale_elems(K, N) : nullptr, out, partial,
                 M, K, N, E * M, e * M, blockIdx.x * kTcBM, (blockIdx.y % n_tiles) * kTcBN,
                 chunks_per_split, smem);
}

template <int F>
__global__ void __launch_bounds__(kQmmThreads)
qmm_gather_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ ids,
                  const uint8_t* __restrict__ codes, const uint8_t* __restrict__ qh,
                  const __nv_bfloat16* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ minus, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ partial, int T, int K, int N, int E,
                  int chunks_per_split) {
  using P = QmmFormat<F>;
  const int t = blockIdx.y;
  const int e = ids[t];  // the block loads its own expert id
  if (e < 0 || e >= E) {
    // an id outside the stack gives a NaN row, never another expert's product
    const int n0 = (blockIdx.x * kQmmThreads + threadIdx.x) * kQmmCols;
    float nan_row[1][kQmmCols];
    for (int j = 0; j < kQmmCols; ++j) nan_row[0][j] = __int_as_float(0x7fc00000);
    if (n0 < N) qmm_store<1>(nan_row, out, partial, 1, N, T, t, 0, n0);
    return;
  }
  qmm_body<1, F>(x + (size_t)t * K, codes + e * P::code_elems(K, N),
                 P::has_qh ? qh + e * P::qh_elems(K, N) : nullptr,
                 scale + e * P::scale_elems(K, N),
                 P::has_minus ? minus + e * P::scale_elems(K, N) : nullptr, out, partial,
                 1, K, N, T, t, 0, chunks_per_split);
}

__global__ void qmm_stack_reduce_kernel(const float* __restrict__ partial,
                                        __nv_bfloat16* __restrict__ out, long long mn,
                                        int split) {
  qmm_reduce_body(partial, out, mn, split);
}

__global__ void qmm_gather_reduce_kernel(const float* __restrict__ partial,
                                         __nv_bfloat16* __restrict__ out, long long mn,
                                         int split) {
  qmm_reduce_body(partial, out, mn, split);
}

// grid (M tiles, E × N tiles, split)
template <int F>
int launch_stack(const void* x, const void* codes, const void* qh, const void* scale,
                 const void* minus, void* out, void* partial, int M, int K, int N, int E,
                 long long x_stride, int split, int per, cudaStream_t s) {
  constexpr int smem = qmm_tc_smem_bytes<F>();
  const int n_tiles = (N + kTcBN - 1) / kTcBN;
  if ((long long)E * n_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = qmm_tc_attributes(qmm_stack_kernel<F>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kTcBM - 1) / kTcBM, E * n_tiles, split);
  qmm_stack_kernel<F><<<grid, kTcThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(qh), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(minus), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), M, K, N, E, n_tiles, x_stride, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long mn = (long long)E * M * N;
  qmm_stack_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out), mn, split);
  return (int)cudaGetLastError();
}

template <int F>
int launch_gather(const void* x, const void* ids, const void* codes, const void* qh,
                  const void* scale, const void* minus, void* out, void* partial, int T,
                  int K, int N, int E, int split, int per, cudaStream_t s) {
  if (T > 65535) return (int)cudaErrorInvalidValue;
  qmm_gather_kernel<F><<<qmm_grid(N, T, split), kQmmThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(ids),
      static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(qh),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(minus),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial), T, K, N, E, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long mn = (long long)T * N;
  qmm_gather_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out), mn, split);
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: a tpullm::QmmFmt of this library's family; planes [E, rows, N]; x
// [M, K] with x_stride 0 (shared) or [E, M, K] with x_stride M·K; out
// [E, M, N].
extern "C" int tpullm_qmm_stack(int fmt, const void* x, const void* codes, const void* qh,
                                const void* scale, const void* minus, void* out,
                                void* partial, int M, int K, int N, int E,
                                long long x_stride, int split, int per,
                                void* stream_ptr) {
  if (!tpullm::qmm_shape_ok(K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (fmt) {
#define TPULLM_QMM_CASE(F) \
    case tpullm::F: return launch_stack<tpullm::F>(x, codes, qh, scale, minus, out, partial, M, K, N, E, x_stride, split, per, s);
    TPULLM_QMM_FORMATS(TPULLM_QMM_CASE)
#undef TPULLM_QMM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// x [T, K], ids [T] int32 on the card, planes [E, rows, N] → out [T, N].
extern "C" int tpullm_qmm_gather(int fmt, const void* x, const void* ids, const void* codes,
                                 const void* qh, const void* scale, const void* minus,
                                 void* out, void* partial, int T, int K, int N, int E,
                                 int split, int per, void* stream_ptr) {
  if (!tpullm::qmm_shape_ok(K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (fmt) {
#define TPULLM_QMM_CASE(F) \
    case tpullm::F: return launch_gather<tpullm::F>(x, ids, codes, qh, scale, minus, out, partial, T, K, N, E, split, per, s);
    TPULLM_QMM_FORMATS(TPULLM_QMM_CASE)
#undef TPULLM_QMM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
