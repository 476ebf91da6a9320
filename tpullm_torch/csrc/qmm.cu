// Fused dequantize×matmul over the v2 plane schema, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpullm/ops/pallas/qmm.py::_kernel_mat (+ _acc_tile),
// launched by _qmm_2d: y [M, N] = x [M, K] · dequant(planes), for the 13
// plane formats of qmm_body.cuh (this library: the formats of family
// TPULLM_QMM_FAMILY). The arithmetic and its rounding points are in
// qmm_body.cuh.
//
// What bounds it on the card: at decode (M = 1) the plane bytes (4 to 6 bits
// a weight for the packed formats with their bf16 scales, 8.5 for Q6_K's qw
// and Q8_0) against 3.35 TB/s; at prefill the CUDA-core FMAs (no tensor
// cores yet). Few output columns at decode leave the card idle, so K is split
// over blockIdx.z into f32 partials summed by a second pass in a fixed order.

#include "qmm_body.cuh"

namespace {

using namespace tpullm;

template <int TM, int F>
__global__ void __launch_bounds__(kQmmThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
           const uint8_t* __restrict__ qh, const __nv_bfloat16* __restrict__ scale,
           const __nv_bfloat16* __restrict__ minus, __nv_bfloat16* __restrict__ out,
           float* __restrict__ partial, int M, int K, int N, int chunks_per_split) {
  qmm_body<TM, F>(x, codes, qh, scale, minus, out, partial, M, K, N, M, 0,
                  blockIdx.y * TM, chunks_per_split);
}

__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  __nv_bfloat16* __restrict__ out, long long mn, int split) {
  qmm_reduce_body(partial, out, mn, split);
}

template <int F>
int launch(const void* x, const void* codes, const void* qh, const void* scale,
           const void* minus, void* out, void* partial, int M, int K, int N, int tm,
           int split, int chunks_per_split, cudaStream_t stream) {
  const dim3 grid = qmm_grid(N, (M + tm - 1) / tm, split);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* cb = static_cast<const uint8_t*>(codes);
  const auto* hb = static_cast<const uint8_t*>(qh);
  const auto* sb = static_cast<const __nv_bfloat16*>(scale);
  const auto* mb = static_cast<const __nv_bfloat16*>(minus);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* pb = static_cast<float*>(partial);
  switch (tm) {
    case 1: qmm_kernel<1, F><<<grid, kQmmThreads, 0, stream>>>(xb, cb, hb, sb, mb, ob, pb, M, K, N, chunks_per_split); break;
    case 2: qmm_kernel<2, F><<<grid, kQmmThreads, 0, stream>>>(xb, cb, hb, sb, mb, ob, pb, M, K, N, chunks_per_split); break;
    case 4: qmm_kernel<4, F><<<grid, kQmmThreads, 0, stream>>>(xb, cb, hb, sb, mb, ob, pb, M, K, N, chunks_per_split); break;
    case 8: qmm_kernel<8, F><<<grid, kQmmThreads, 0, stream>>>(xb, cb, hb, sb, mb, ob, pb, M, K, N, chunks_per_split); break;
    case 16: qmm_kernel<16, F><<<grid, kQmmThreads, 0, stream>>>(xb, cb, hb, sb, mb, ob, pb, M, K, N, chunks_per_split); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long mn = (long long)M * N;
  qmm_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(pb, ob, mn, split);
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: a tpullm::QmmFmt of this library's family (else cudaErrorInvalidValue).
// qh is read only by the formats with a qh plane, minus only by those with a
// minus plane; the others may be null.
extern "C" int tpullm_qmm(int fmt, const void* x, const void* codes, const void* qh,
                          const void* scale, const void* minus, void* out, void* partial,
                          int M, int K, int N, int tm, int split, int chunks_per_split,
                          void* stream_ptr) {
  if (!tpullm::qmm_shape_ok(K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (fmt) {
#define TPULLM_QMM_CASE(F) \
    case tpullm::F: return launch<tpullm::F>(x, codes, qh, scale, minus, out, partial, M, K, N, tm, split, chunks_per_split, s);
    TPULLM_QMM_FORMATS(TPULLM_QMM_CASE)
#undef TPULLM_QMM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
