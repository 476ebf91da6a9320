// The dequantize×matmul device body below 16 rows of x (decode, the prefill
// bucket of 8), on CUDA cores: qmm_kernel of qmm.cu.
//
// It replaces, at M < 16, tpullm/ops/pallas/qmm.py::_kernel_mat + _acc_tile
// (the pallas_call in _qmm_2d) and keeps _acc_tile's rounding points, those
// of ops/kernels/qmm.py::qmm_reference: each weight rounded to bf16 after
// its f32 scale multiply, the min term through f32 group sums of bf16 x,
// f32 sums, the output rounded to bf16 once.
//
// What bounds it on the card: the plane bytes (8B Q4_K gate_up: 73 MB,
// 0.022 ms at 3.35 TB/s) and, close behind, the instructions that decode
// them (a few per weight). What the design does about that:
// - The weight stream. A block owns 128 output columns and a K range of
//   whole 256-row chunks. Each chunk's slice of every plane (codes, qh,
//   scales, minus: 8.3–36 KB) goes into a ring of 2 or 3 stages in shared
//   memory by 16-byte cp.async copies (4-byte ones when N % 16 ≠ 0), issued
//   stages − 1 chunks ahead, one barrier a chunk. Stages of at most 24 KB
//   get a ring of 3, larger ones of 2: 17–40 KB of planes a block in flight,
//   2–4 blocks an SM (70–120 KB an SM), against the ≈ 25–40 KB an SM that
//   Little's law asks at 3.35 TB/s and about a microsecond of latency. K is
//   split (ops/kernels/qmm.py gemv_plan) only as far as keeps every block in
//   one wave of 2 blocks an SM: a wave and a few blocks more left most SMs
//   idle for a whole block's time on the card.
// - The decode. Warp j of the block's 4 takes step j (64 slots) of every
//   chunk, in the order of the tensor-core body (TcOrder): a U = 256
//   half-split step is packed rows 32j .. 32j+31 (both nibbles), a 2-bit
//   step packed rows 16j .. 16j+15 (all four fields), so every packed byte
//   is read once from shared memory and whole scale groups stay in one
//   warp. A lane owns 4 neighbouring columns (a warp reads 128 contiguous
//   plane bytes a row, conflict-free). The identity and bias maps decode
//   two columns at a time as bf16 pairs (codes_times_scales: one bf16
//   multiply rounds the exact product, as the f32 path does); the code
//   tables and the signed bytes multiply in f32 and round once.
// - x for the block's K range is copied once into shared memory as bf16
//   (at most kGemvXBytes; ops/kernels/qmm.py plan() splits K further
//   rather than exceed it). The minus group sums are computed once per
//   block, each by the warp that owns its group, 32 lanes and a shuffle
//   tree, with no barrier.
// - The 4 warps' sums meet in shared memory, added in warp order. When K
//   is split (the output tiles alone too few to fill the card), each block
//   writes f32 partials; the last block of a column tile to finish, found
//   through a counter of the launch's stream that it resets, adds them in
//   split order and rounds once: deterministic, no atomics on the sums, and
//   one launch a call (the old body needed a second, reduction launch).
#pragma once

#include "qmm_tc.cuh"

namespace tpullm {

constexpr int kGemvThreads = 128;   // 4 warps: warp j takes step j of every chunk
constexpr int kGemvBN = 128;        // output columns a block, 4 a lane
constexpr int kGemvXBytes = 32768;  // x of a block's K range (ops/kernels/qmm.py GEMV_X_BYTES)

// One chunk's slice of the planes for the block's 128 columns: the code
// rows (128 bytes each), the qh rows, then the scale and minus rows (256
// bytes each), every row 16-byte aligned.
template <class P>
struct GemvStage {
  static constexpr int code_rows = kQmmChunk / P::code_div;
  static constexpr int qh_rows = P::has_qh ? kQmmChunk / 8 : 0;
  static constexpr int g_rows = kQmmChunk / P::G;
  static constexpr int qh_off = code_rows * kGemvBN;
  static constexpr int scale_off = qh_off + qh_rows * kGemvBN;
  static constexpr int minus_off = scale_off + g_rows * kGemvBN * 2;
  static constexpr int bytes = minus_off + (P::has_minus ? g_rows * kGemvBN * 2 : 0);
  static constexpr int stages = bytes > 24576 ? 2 : 3;
  static constexpr int ring = stages * bytes;
  static_assert(ring >= 4 * 8 * kGemvBN * 4, "the ring holds the warps' sums at TM = 8");
};

// Dynamic shared memory of a block: the ring, x (x_bytes), the code table
// and the last-block flag.
template <int F>
constexpr int gemv_smem_bytes(int x_bytes) {
  return GemvStage<QmmFormat<F>>::ring + x_bytes + 16 * 4 + 16;
}

// `rows` plane rows of `row_bytes` from src (rows src_pitch bytes apart; the
// first `valid` bytes of each in range, the rest zero-filled) into dst
__device__ __forceinline__ void gemv_copy(char* dst, const char* src, int rows, int row_bytes,
                                          size_t src_pitch, int valid, bool vec16) {
  if (vec16) {
    const int segs = row_bytes / 16;
    for (int i = threadIdx.x; i < rows * segs; i += kGemvThreads) {
      const int r = i / segs, o = (i % segs) * 16;
      const bool ok = o < valid;
      cp_async16(dst + r * row_bytes + o, ok ? src + (size_t)r * src_pitch + o : src, ok ? 16 : 0);
    }
  } else {
    const int segs = row_bytes / 4;
    for (int i = threadIdx.x; i < rows * segs; i += kGemvThreads) {
      const int r = i / segs, o = (i % segs) * 4;
      const bool ok = o < valid;
      cp_async4(dst + r * row_bytes + o, ok ? src + (size_t)r * src_pitch + o : src, ok ? 4 : 0);
    }
  }
}

// the two f32 of a bf16 pair
__device__ __forceinline__ void unpack2(uint32_t u, float& a, float& b) {
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}

// The 4 weights (columns of one packed word q, code bits at `sh`, BITS wide;
// the qh bit at `hbit` of h) times their scales s, each rounded once to bf16.
template <class P, int BITS>
__device__ __forceinline__ void gemv_w4(uint32_t q, int sh, uint32_t h, int hbit, uint2 s,
                                        const float* lut, float (&w)[4]) {
  constexpr uint32_t mask = ((1u << BITS) - 1u) * 0x00010001u;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t sel = k ? 0x4342u : 0x4140u;  // bytes 2k, 2k+1 into the halves
    uint32_t pair = (__byte_perm(q, 0, sel) >> sh) & mask;
    if constexpr (P::has_qh) pair |= ((__byte_perm(h, 0, sel) >> hbit) & 0x00010001u) << BITS;
    if constexpr (!P::table) {
      unpack2(codes_times_scales<P>(pair, k ? s.y : s.x), w[2 * k], w[2 * k + 1]);
    } else {
      const __nv_bfloat162 r = __floats2bfloat162_rn(lut[pair & 0xffffu] * bf16x4_at(s, 2 * k),
                                                     lut[pair >> 16] * bf16x4_at(s, 2 * k + 1));
      unpack2(*reinterpret_cast<const uint32_t*>(&r), w[2 * k], w[2 * k + 1]);
    }
  }
}

// the 4 signed-byte weights of a wide word times their scales, rounded once
__device__ __forceinline__ void gemv_w4_wide(uint32_t q, uint2 s, float (&w)[4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(
        (float)(int8_t)((q >> (16 * k)) & 0xffu) * bf16x4_at(s, 2 * k),
        (float)(int8_t)((q >> (16 * k + 8)) & 0xffu) * bf16x4_at(s, 2 * k + 1));
    unpack2(*reinterpret_cast<const uint32_t*>(&r), w[2 * k], w[2 * k + 1]);
  }
}

// acc[m] += x[m][row] · w0 + x[m][row + 1] · w1; xr = &xs[0][row], row even
template <int TM>
__device__ __forceinline__ void gemv_fma2(float (&acc)[TM][4], const __nv_bfloat16* xr, int xk,
                                          const float (&w0)[4], const float (&w1)[4]) {
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + m * xk));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[m][c] = fmaf(xv.x, w0[c], acc[m][c]);
      acc[m][c] = fmaf(xv.y, w1[c], acc[m][c]);
    }
  }
}

// Step j of one chunk for this lane's 4 columns: st the chunk's ring stage,
// xc = &xs[0][chunk's first row] (rows xk apart).
template <int TM, class P>
__device__ __forceinline__ void gemv_step(float (&acc)[TM][4], const char* st,
                                          const __nv_bfloat16* xc, int xk, int j, int lane,
                                          const float* lut) {
  using S = GemvStage<P>;
  using O = TcOrder<P>;
  constexpr int G = P::G;
  const uint8_t* cs = reinterpret_cast<const uint8_t*>(st) + 4 * lane;
  const uint8_t* hs = reinterpret_cast<const uint8_t*>(st + S::qh_off) + 4 * lane;
  const __nv_bfloat16* ss = reinterpret_cast<const __nv_bfloat16*>(st + S::scale_off) + 4 * lane;
  auto word = [](const uint8_t* base, int row) {
    return *reinterpret_cast<const uint32_t*>(base + row * kGemvBN);
  };
  auto scales = [](const __nv_bfloat16* base, int g) {
    return *reinterpret_cast<const uint2*>(base + g * kGemvBN);
  };

  if constexpr (P::layout == kWide) {  // rows 64j .. 64j+63, one signed byte each
    constexpr int GW = G < 64 ? G : 64;
    auto two_rows = [&](int row, uint2 s) {
      float w0[4], w1[4];
      gemv_w4_wide(word(cs, row), s, w0);
      gemv_w4_wide(word(cs, row + 1), s, w1);
      gemv_fma2<TM>(acc, xc + row, xk, w0, w1);
    };
#pragma unroll 1
    for (int g0 = 0; g0 < 64; g0 += GW) {
      const uint2 s = scales(ss, (64 * j + g0) / G);
      if constexpr (TM >= 4) {  // unrolled 4, TM 4 and 8 spill a few registers
#pragma unroll 2
        for (int r = 0; r < GW; r += 2) two_rows(64 * j + g0 + r, s);
      } else {
#pragma unroll 4
        for (int r = 0; r < GW; r += 2) two_rows(64 * j + g0 + r, s);
      }
    }
  } else if constexpr (O::crumb) {
    // packed rows 16j + r: field f is chunk row 64f + 16j + r, of group
    // (64f + 16j) / G for all 16 r; its third bit is bit 2f + j/2 of qh row
    // (16j + r) % 32
    uint2 s[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) s[f] = scales(ss, (64 * f + 16 * j) / G);
#pragma unroll 2
    for (int r = 0; r < 16; r += 2) {
      uint32_t q[2], h[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        q[e] = word(cs, 16 * j + r + e);
        if constexpr (P::has_qh) h[e] = word(hs, (16 * j + r + e) % 32);
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        float w0[4], w1[4];
        gemv_w4<P, 2>(q[0], 2 * f, h[0], 2 * f + (j >> 1), s[f], lut, w0);
        gemv_w4<P, 2>(q[1], 2 * f, h[1], 2 * f + (j >> 1), s[f], lut, w1);
        gemv_fma2<TM>(acc, xc + 64 * f + 16 * j + r, xk, w0, w1);
      }
    }
  } else if constexpr (O::half256) {
    // packed rows 32j + r: chunk rows 32j + r (low nibble, group j) and
    // 128 + 32j + r (high nibble, group 4 + j); their fifth bits are bits j
    // and 4 + j of qh row r
    const uint2 s_lo = scales(ss, j), s_hi = scales(ss, 4 + j);
#pragma unroll 2
    for (int r = 0; r < 32; r += 2) {
      float lo0[4], lo1[4], hi0[4], hi1[4];
      const uint32_t q0 = word(cs, 32 * j + r), q1 = word(cs, 32 * j + r + 1);
      uint32_t h0 = 0u, h1 = 0u;
      if constexpr (P::has_qh) {
        h0 = word(hs, r);
        h1 = word(hs, r + 1);
      }
      gemv_w4<P, 4>(q0, 0, h0, j, s_lo, lut, lo0);
      gemv_w4<P, 4>(q1, 0, h1, j, s_lo, lut, lo1);
      gemv_w4<P, 4>(q0, 4, h0, j + 4, s_hi, lut, hi0);
      gemv_w4<P, 4>(q1, 4, h1, j + 4, s_hi, lut, hi1);
      gemv_fma2<TM>(acc, xc + 32 * j + r, xk, lo0, lo1);
      gemv_fma2<TM>(acc, xc + 128 + 32 * j + r, xk, hi0, hi1);
    }
  } else {
    // U = 32: units u = 2j, 2j + 1, packed rows 16u + r: chunk rows 32u + r
    // (low nibble) and 32u + 16 + r (high), group u; fifth bits: bits r/4
    // and 4 + r/4 of qh row 4u + r % 4
#pragma unroll 1
    for (int uu = 0; uu < 2; ++uu) {
      const int u = 2 * j + uu;
      const uint2 s = scales(ss, u);
#pragma unroll 2
      for (int r = 0; r < 16; r += 2) {
        float lo0[4], lo1[4], hi0[4], hi1[4];
        const uint32_t q0 = word(cs, 16 * u + r), q1 = word(cs, 16 * u + r + 1);
        uint32_t h0 = 0u, h1 = 0u;
        if constexpr (P::has_qh) {
          h0 = word(hs, 4 * u + r % 4);
          h1 = word(hs, 4 * u + (r + 1) % 4);
        }
        gemv_w4<P, 4>(q0, 0, h0, r / 4, s, lut, lo0);
        gemv_w4<P, 4>(q1, 0, h1, (r + 1) / 4, s, lut, lo1);
        gemv_w4<P, 4>(q0, 4, h0, 4 + r / 4, s, lut, hi0);
        gemv_w4<P, 4>(q1, 4, h1, 4 + (r + 1) / 4, s, lut, hi1);
        gemv_fma2<TM>(acc, xc + 32 * u + r, xk, lo0, lo1);
        gemv_fma2<TM>(acc, xc + 32 * u + 16 + r, xk, hi0, hi1);
      }
    }
  }

  if constexpr (P::has_minus) {
    // the min term of the warp's groups: segment sg is one whole group, its
    // sum of bf16 x over 32 lanes (lanes past the group add 0)
    const __nv_bfloat16* ms = reinterpret_cast<const __nv_bfloat16*>(st + S::minus_off) + 4 * lane;
    static_assert(O::SEG == G, "a minus segment is one whole group");
#pragma unroll
    for (int sg = 0; sg < O::NSEG; ++sg) {
      const int row0 = O::row(j, sg * O::SEG);
      float mn[4];
      const uint2 mw = scales(ms, row0 / G);
#pragma unroll
      for (int c = 0; c < 4; ++c) mn[c] = bf16x4_at(mw, c);
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const float xv = lane < G ? __bfloat162float(xc[m * xk + row0 + lane]) : 0.f;
        const float gs = warp_sum(xv);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(-gs, mn[c], acc[m][c]);
      }
    }
  }
}

// Rows m0 .. m0+TM-1 of x [M, K] times the [K, N] weight into out [M, N],
// columns blockIdx.x · 128 .., chunks [blockIdx.z · per, +per). smem:
// gemv_smem_bytes<F>(TM · per · 512). With gridDim.z > 1 the blocks of a
// column tile write partial [split, M, N] and the last of them sums it;
// counters[blockIdx.y · gridDim.x + blockIdx.x] is 0 before and after.
template <int TM, int F>
__device__ __forceinline__ void qmm_gemv_body(const __nv_bfloat16* __restrict__ x,
                                              const uint8_t* __restrict__ codes,
                                              const uint8_t* __restrict__ qh,
                                              const __nv_bfloat16* __restrict__ scale,
                                              const __nv_bfloat16* __restrict__ minus,
                                              __nv_bfloat16* __restrict__ out,
                                              float* __restrict__ partial,
                                              int* __restrict__ counters, int M, int K, int N,
                                              int chunks_per_split, char* smem) {
  using P = QmmFormat<F>;
  using S = GemvStage<P>;
  const int xk = chunks_per_split * kQmmChunk;  // bf16 an x row in shared memory
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + S::ring);
  float* lut = reinterpret_cast<float*>(smem + S::ring + TM * xk * 2);
  int* flag = reinterpret_cast<int*>(lut + 16);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kGemvBN, m0 = blockIdx.y * TM;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int nch = min(K / kQmmChunk, c_begin + chunks_per_split) - c_begin;
  const bool vec16 = N % 16 == 0;
  const int cols = min(kGemvBN, N - n0);  // columns in range (a multiple of 4)
  if constexpr (P::table) qmm_fill_table<P>(lut);  // visible after the first barrier

  // x rows m0.. of the block's K range; rows past M zero
  for (int i = tid; i < TM * (xk / 8); i += kGemvThreads) {
    const int m = i / (xk / 8), o = (i % (xk / 8)) * 8;
    const bool ok = m0 + m < M && o < nch * kQmmChunk;
    cp_async16(xs + m * xk + o, ok ? x + (size_t)(m0 + m) * K + (size_t)c_begin * kQmmChunk + o : x,
               ok ? 16 : 0);
  }
  auto load_stage = [&](int i) {
    char* st = smem + (i % S::stages) * S::bytes;
    const size_t c = c_begin + i;
    gemv_copy(st, reinterpret_cast<const char*>(codes + c * S::code_rows * N + n0), S::code_rows,
              kGemvBN, N, cols, vec16);
    if constexpr (P::has_qh)
      gemv_copy(st + S::qh_off, reinterpret_cast<const char*>(qh + c * S::qh_rows * N + n0),
                S::qh_rows, kGemvBN, N, cols, vec16);
    gemv_copy(st + S::scale_off, reinterpret_cast<const char*>(scale + c * S::g_rows * N + n0),
              S::g_rows, 2 * kGemvBN, (size_t)2 * N, 2 * cols, vec16);
    if constexpr (P::has_minus)
      gemv_copy(st + S::minus_off, reinterpret_cast<const char*>(minus + c * S::g_rows * N + n0),
                S::g_rows, 2 * kGemvBN, (size_t)2 * N, 2 * cols, vec16);
  };
#pragma unroll
  for (int s = 0; s < S::stages - 1; ++s) {
    if (s < nch) load_stage(s);
    cp_async_commit();
  }

  float acc[TM][4];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int i = 0; i < nch; ++i) {
    cp_async_wait<S::stages - 2>();  // this thread's copies of chunk i landed
    __syncthreads();  // everyone's landed; chunk i-1's readers are done with its stage
    if (i + S::stages - 1 < nch) load_stage(i + S::stages - 1);
    cp_async_commit();
    gemv_step<TM, P>(acc, smem + (i % S::stages) * S::bytes, xs + i * kQmmChunk, xk, warp, lane,
                     lut);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' sums meet there

  float* red = reinterpret_cast<float*>(smem);  // [4 warps][TM][128]
#pragma unroll
  for (int m = 0; m < TM; ++m)
    *reinterpret_cast<float4*>(red + (warp * TM + m) * kGemvBN + 4 * lane) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int n = n0 + tid;  // one column a thread from here
  float v[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    v[m] = red[m * kGemvBN + tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) v[m] += red[(w * TM + m) * kGemvBN + tid];
  }
  if (gridDim.z == 1) {
    if (n < N) {
#pragma unroll
      for (int m = 0; m < TM; ++m)
        if (m0 + m < M) out[(size_t)(m0 + m) * N + n] = __float2bfloat16_rn(v[m]);
    }
    return;
  }
  if (n < N) {
#pragma unroll
    for (int m = 0; m < TM; ++m)
      if (m0 + m < M) partial[((size_t)blockIdx.z * M + m0 + m) * N + n] = v[m];
  }
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) *flag = atomicAdd(counter, 1) == (int)gridDim.z - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();  // the last block: every split's partials are visible
  if (n < N) {
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      if (m0 + m >= M) break;
      float s = 0.f;
#pragma unroll 8
      for (int z = 0; z < (int)gridDim.z; ++z)  // in split order
        s += __ldcg(partial + ((size_t)z * M + m0 + m) * N + n);
      out[(size_t)(m0 + m) * N + n] = __float2bfloat16_rn(s);
    }
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

}  // namespace tpullm
