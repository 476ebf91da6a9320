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
//   (launched by _qmm_gather): out[t] = x[t] · dequant(W[ids[t]]) for x [T,
//   K] and ids [T] on the card, on the gemv body of qmm_gemv.cuh (the one
//   qmm below 16 rows runs). Where the TPU prefetched ids as scalars to pick
//   the plane blocks, every block here reads ids itself, so the host never
//   reads the routing. Bound on the card: the routed experts' plane bytes
//   (decode: 2 slots a token, two experts) against 3.35 TB/s. The design:
//   - The grid walks (column tile of 128, expert rank, K split). Rank y is
//     the y-th smallest expert that ids routes to: min(T, E) ranks cover
//     every routed expert, and a rank past the distinct experts exits
//     before its first copy (so no block streams an expert no slot uses).
//   - A block collects its expert's slots from ids (in slot order, 128 ids
//     a round) and runs them through the gemv body in row tiles of up to
//     TMX rows (1, 2, 4 or 8, the least that covers min(T, 8): a launch
//     parameter): x rows gathered by slot into shared memory, output rows
//     scattered back by slot, the expert's planes streamed once a tile. Each
//     routed expert is read once for up to 8 of its slots, never once a
//     slot. A tile of one slot (every tile at decode: a token's experts are
//     distinct) runs the body at TM = 1, others at TM = TMX: two bodies a
//     kernel, so its registers are those of the larger, not of all four.
//   - K is split over blockIdx.z (ops/kernels/qmm.py gather_plan: the wave
//     rule of qmm's gemv_plan over min(T, E) experts' column tiles); the
//     last block of each (rank, column tile) sums the splits of every slot
//     of its expert in split order, through a counter of the launch's
//     stream, in the same launch.
//   - An id outside 0..E-1 gives a NaN row, written by the blocks of rank 0
//     and split 0, never another expert's product.
//   - A block finds its expert before its first copy: with T ≤ 32 slots and
//     E ≤ 32 experts (Mixtral's decode and short prefill) each warp holds
//     the ids a lane each and finds it by warp votes, one barrier; else
//     through a bit set of the routed experts in shared memory.

#include "qmm_gemv.cuh"

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
  qmm_tc_body<F, false>(x + (size_t)e * x_stride, codes + e * P::code_elems(K, N),
                 P::has_qh ? qh + e * P::qh_elems(K, N) : nullptr,
                 scale + e * P::scale_elems(K, N),
                 P::has_minus ? minus + e * P::scale_elems(K, N) : nullptr, out, partial,
                 M, K, N, E * M, e * M, blockIdx.x * kTcBM, (blockIdx.y % n_tiles) * kTcBN,
                 chunks_per_split, smem);
}

// The ids in [p, p + 128) that route to expert e, in slot order, into
// slots; returns their count (block-uniform). Starts and ends with a
// barrier: the round before is done with slots, the ring and x.
__device__ __forceinline__ int gather_collect(const int* __restrict__ ids, int T, int p, int e,
                                              int* slots, int* warp_hits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  const int t = p + threadIdx.x;
  const bool hit = t < T && ids[t] == e;
  const unsigned b = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) warp_hits[warp] = __popc(b);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kGemvThreads / 32; ++w) {
    off += w < warp ? warp_hits[w] : 0;
    total += warp_hits[w];
  }
  if (hit) slots[off + __popc(b & ((1u << lane) - 1u))] = t;
  __syncthreads();
  return total;
}

// The position of the y-th (from 0) set bit of b; -1 past the last.
__device__ __forceinline__ int nth_bit(unsigned b, int y) {
  for (int k = 0; k < y && b; ++k) b &= b - 1;  // drop the lower bits
  return b ? __ffs(b) - 1 : -1;
}

// grid (column tiles, min(T, E) expert ranks, split); smem:
// gemv_smem_bytes<F>(TMX · per · 512) + the routed-expert bit set (4 ·
// ⌈E/32⌉ bytes). TMX (1, 2, 4 or 8) covers min(T, 8). With split > 1,
// partial [split, T, N] and counters[rank · gridDim.x + column tile], zero
// before and after.
template <int TMX, int F>
__global__ void __launch_bounds__(kGemvThreads)
qmm_gather_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ ids,
                  const uint8_t* __restrict__ codes, const uint8_t* __restrict__ qh,
                  const __nv_bfloat16* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ minus, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ partial, int* __restrict__ counters, int T, int K, int N,
                  int E, int chunks_per_split) {
  using P = QmmFormat<F>;
  extern __shared__ __align__(16) char smem[];
  __shared__ int slots[kGemvThreads];  // a round's slots of the block's expert
  __shared__ int warp_hits[kGemvThreads / 32];
  __shared__ int expert, any_invalid;
  int* flag = gemv_flag(gemv_lut<P>(smem, TMX * chunks_per_split * kQmmChunk * 2));
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = blockIdx.x * kGemvBN + tid;
  const bool nan_rows = blockIdx.y == 0 && blockIdx.z == 0 && n < N;
  const __nv_bfloat16 nan = __float2bfloat16_rn(__int_as_float(0x7fc00000));

  // The block's expert: the blockIdx.y-th, in ascending order, of the
  // experts that ids routes to (-1: fewer experts), and its slots among the
  // first 128 ids (count0, in slots). An id outside the stack gives a NaN
  // row, written by the blocks of rank 0 and split 0, never another
  // expert's product.
  int e, count0;
  if (T <= 32 && E <= 32) {
    // every warp holds all the ids, one a lane: no shared memory, one barrier
    const int id = lane < T ? ids[lane] : -1;
    const bool valid = lane < T && id >= 0 && id < E;
    e = nth_bit(__reduce_or_sync(0xffffffffu, valid ? 1u << id : 0u), blockIdx.y);
    const unsigned hits = __ballot_sync(0xffffffffu, valid && id == e);
    const unsigned invalid = __ballot_sync(0xffffffffu, lane < T && !valid);
    if (tid < 32 && ((hits >> lane) & 1u)) slots[__popc(hits & ((1u << lane) - 1u))] = lane;
    count0 = __popc(hits);
    if (invalid && nan_rows)
      for (unsigned b = invalid; b; b &= b - 1) out[(size_t)(__ffs(b) - 1) * N + n] = nan;
    __syncthreads();
  } else {
    // the routed experts as a bit set in shared memory
    unsigned* routed = reinterpret_cast<unsigned*>(flag + 4);
    const int words = (E + 31) / 32;
    for (int i = tid; i < words; i += kGemvThreads) routed[i] = 0u;
    if (tid == 0) any_invalid = 0;
    __syncthreads();
    for (int t = tid; t < T; t += kGemvThreads) {
      const int id = ids[t];
      if (id >= 0 && id < E) atomicOr(routed + (id >> 5), 1u << (id & 31));
      else any_invalid = 1;
    }
    __syncthreads();
    if (tid == 0) {
      int want = blockIdx.y;
      expert = -1;
      for (int w = 0; w < words; ++w) {
        const int c = __popc(routed[w]);
        if (want < c) {
          expert = 32 * w + nth_bit(routed[w], want);
          break;
        }
        want -= c;
      }
    }
    __syncthreads();
    e = expert;
    if (any_invalid && nan_rows) {
      for (int t = 0; t < T; ++t) {
        const int id = ids[t];
        if (id < 0 || id >= E) out[(size_t)t * N + n] = nan;
      }
    }
    count0 = e < 0 ? 0 : gather_collect(ids, T, 0, e, slots, warp_hits);
  }
  if (e < 0) return;

  const uint8_t* ce = codes + e * P::code_elems(K, N);
  const uint8_t* he = P::has_qh ? qh + e * P::qh_elems(K, N) : nullptr;
  const __nv_bfloat16* se = scale + e * P::scale_elems(K, N);
  const __nv_bfloat16* me = P::has_minus ? minus + e * P::scale_elems(K, N) : nullptr;
  for (int p = 0; p < T; p += kGemvThreads) {
    const int count = p ? gather_collect(ids, T, p, e, slots, warp_hits) : count0;
    for (int r0 = 0; r0 < count; r0 += TMX) {
      if (r0) __syncthreads();  // the tile before has read its sums from the ring
      const SlotRows rows{slots + r0, min(TMX, count - r0)};
      // The values the body's address arithmetic starts from pass through
      // an empty asm each tile, so that the compiler recomputes that
      // arithmetic in the tile instead of hoisting it out of the loops and
      // holding it in registers across tiles (the kernel took 232–255
      // registers that way, against the 2-D kernel's 80–128, and ran
      // slower at decode).
      int k = K, nn = N, per = chunks_per_split;
      const __nv_bfloat16 *xt = x, *st = se, *mt = me;
      const uint8_t *ct = ce, *ht = he;
      asm volatile("" : "+r"(k), "+r"(nn), "+r"(per), "+l"(xt), "+l"(ct), "+l"(ht), "+l"(st),
                   "+l"(mt));
      if (TMX == 1 || rows.count == 1)
        qmm_gemv_body<1, F, false, false, TMX>(xt, ct, ht, st, mt, out, partial, counters, rows,
                                               T, k, nn, per, smem);
      else
        qmm_gemv_body<TMX, F, false, false, TMX>(xt, ct, ht, st, mt, out, partial, counters, rows,
                                                 T, k, nn, per, smem);
    }
  }
  if (gridDim.z == 1) return;
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (!gemv_last_block(counter, flag)) return;
  for (int p = 0; p < T; p += kGemvThreads) {  // every slot of the expert
    const int count = T > kGemvThreads ? gather_collect(ids, T, p, e, slots, warp_hits) : count0;
    if (n < N)
      for (int i = 0; i < count; ++i) gemv_sum_splits(partial, out, slots[i], T, N, n);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

__global__ void qmm_stack_reduce_kernel(const float* __restrict__ partial,
                                        __nv_bfloat16* __restrict__ out, long long mn,
                                        int split) {
  qmm_reduce_body(partial, out, mn, split);
}

// grid (M tiles, E × N tiles, split)
template <int F>
int launch_stack(const void* x, const void* codes, const void* qh, const void* scale,
                 const void* minus, void* out, void* partial, int M, int K, int N, int E,
                 long long x_stride, int split, int per, cudaStream_t s) {
  constexpr int smem = qmm_tc_smem_bytes<F, false>();
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

// the largest expert count the routed-expert bit set takes (8 KB)
constexpr int kGatherMaxExperts = 65535;

template <int TMX, int F>
int launch_gather_tm(const void* x, const void* ids, const void* codes, const void* qh,
                     const void* scale, const void* minus, void* out, void* partial,
                     void* counters, int T, int K, int N, int E, int split, int per,
                     cudaStream_t s) {
  const int x_bytes = TMX * per * kQmmChunk * 2;
  if (T < 1 || E < 1 || E > kGatherMaxExperts || x_bytes > kGemvXBytes || split > 65535 ||
      TMX < min(T, 8))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      qmm_tc_attributes(qmm_gather_kernel<TMX, F>, gemv_smem_bytes<F>(kGemvXBytes) +
                                                       4 * ((kGatherMaxExperts + 31) / 32));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + kGemvBN - 1) / kGemvBN, min(T, E), split);
  qmm_gather_kernel<TMX, F><<<grid, kGemvThreads, gemv_smem_bytes<F>(x_bytes) + 4 * ((E + 31) / 32), s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(ids),
      static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(qh),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(minus),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial),
      static_cast<int*>(counters), T, K, N, E, per);
  return (int)cudaGetLastError();
}

// x_rows: the gather's TMX, which matches ops/kernels/qmm.py GEMV_TMS
template <int F>
int launch_gather(const void* x, const void* ids, const void* codes, const void* qh,
                  const void* scale, const void* minus, void* out, void* partial,
                  void* counters, int T, int K, int N, int E, int x_rows, int split, int per,
                  cudaStream_t s) {
  switch (x_rows) {
#define TPULLM_GATHER_CASE(TMX)                                                            \
    case TMX: return launch_gather_tm<TMX, F>(x, ids, codes, qh, scale, minus, out, partial, \
                                              counters, T, K, N, E, split, per, s);
    TPULLM_GATHER_CASE(1) TPULLM_GATHER_CASE(2) TPULLM_GATHER_CASE(4) TPULLM_GATHER_CASE(8)
#undef TPULLM_GATHER_CASE
    default: return (int)cudaErrorInvalidValue;
  }
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

// x [T, K], ids [T] int32 on the card, planes [E, rows, N] → out [T, N];
// x_rows in {1, 2, 4, 8} covering min(T, 8); with split > 1, partial f32
// [split, T, N] and counters int32 [min(T, E) · ⌈N/128⌉], zero before the
// launch and left zero after it (calls on one stream).
extern "C" int tpullm_qmm_gather(int fmt, const void* x, const void* ids, const void* codes,
                                 const void* qh, const void* scale, const void* minus,
                                 void* out, void* partial, void* counters, int T, int K, int N,
                                 int E, int x_rows, int split, int per, void* stream_ptr) {
  if (!tpullm::qmm_shape_ok(K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (fmt) {
#define TPULLM_QMM_CASE(F) \
    case tpullm::F: return launch_gather<tpullm::F>(x, ids, codes, qh, scale, minus, out, partial, counters, T, K, N, E, x_rows, split, per, s);
    TPULLM_QMM_FORMATS(TPULLM_QMM_CASE)
#undef TPULLM_QMM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
