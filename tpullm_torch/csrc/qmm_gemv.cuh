// The dequantize×matmul device body below 16 rows of x (decode, the prefill
// bucket of 8, the expert gather), on CUDA cores, shared by three kernels:
// qmm_kernel and qmm_grouped_gemv_kernel of qmm.cu and qmm_gather_kernel
// of qmm_moe.cu. One body, qmm_gemv_body: a row map (the block's rows of x
// and of the output, contiguous or a slot list) and the planes' base (an
// expert's, for the gather) are its arguments.
//
// It replaces, at M < 16, tpullm/ops/pallas/qmm.py::_kernel_mat + _acc_tile
// (the pallas_call in _qmm_2d) and keeps _acc_tile's rounding points, those
// of ops/kernels/qmm.py::qmm_reference: each weight rounded to bf16 after
// its f32 scale multiply, the min term through f32 group sums of bf16 x,
// f32 sums, the output rounded to bf16 once. With Grouped it computes the
// group-factored function of _kernel (qmm_grouped_reference's rounding):
// per scale segment, f32 sums of bf16 x times the unscaled value, scaled
// once (gemv_grouped_step). The gather (_kernel_gather) is _acc_tile's
// function, row by row, through the expert of each row.
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
// - x for the block's K range is copied once into shared memory as bf16,
//   row by row through the row map (at most kGemvXBytes;
//   ops/kernels/qmm.py gemv_plan and gather_plan split K further
//   rather than exceed it). The minus group sums are computed once per
//   block, each by the warp that owns its group, 32 lanes and a shuffle
//   tree, with no barrier.
// - The 4 warps' sums meet in shared memory, added in warp order. When K
//   is split (the output tiles alone too few to fill the card), each block
//   writes f32 partials; the last block of a column tile (of the gather: of
//   an expert's column tile) to finish, found through a counter of the
//   launch's stream that it resets, adds them in split order and rounds
//   once: deterministic, no atomics on the sums, and one launch a call.
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
// and the last-block flag (gemv_lut, gemv_flag; 16 bytes).
template <int F>
constexpr int gemv_smem_bytes(int x_bytes) {
  return GemvStage<QmmFormat<F>>::ring + x_bytes + 16 * 4 + 16;
}

template <class P>
__device__ __forceinline__ float* gemv_lut(char* smem, int x_bytes) {
  return reinterpret_cast<float*>(smem + GemvStage<P>::ring + x_bytes);
}
__device__ __forceinline__ int* gemv_flag(float* lut) { return reinterpret_cast<int*>(lut + 16); }

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

// The 4 unscaled values of one packed word's columns (code bits at `sh`,
// BITS wide; the qh bit at `hbit` of h), as the group-factored function
// takes them: the raw code of the identity and bias maps (the bias goes
// through the minus_eff term), exact as a bf16 pair, or the table value.
template <class P, int BITS>
__device__ __forceinline__ void gemv_v4(uint32_t q, int sh, uint32_t h, int hbit, const float* lut,
                                        float (&v)[4]) {
  constexpr uint32_t mask = ((1u << BITS) - 1u) * 0x00010001u;
  constexpr uint32_t kMagic = 0x43004300u;  // bf16 128.0 in each half
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t sel = k ? 0x4342u : 0x4140u;  // bytes 2k, 2k+1 into the halves
    uint32_t pair = (__byte_perm(q, 0, sel) >> sh) & mask;
    if constexpr (P::has_qh) pair |= ((__byte_perm(h, 0, sel) >> hbit) & 0x00010001u) << BITS;
    if constexpr (P::table) {
      v[2 * k] = lut[pair & 0xffffu];
      v[2 * k + 1] = lut[pair >> 16];
    } else {  // 128 + code less 128, exact in bf16 (code < 128)
      unpack2(as_u32(__hsub2(as_bf162(pair | kMagic), as_bf162(kMagic))), v[2 * k], v[2 * k + 1]);
    }
  }
}

// the 4 signed bytes of a wide word as f32
__device__ __forceinline__ void gemv_v4_wide(uint32_t q, float (&v)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = (float)(int8_t)((q >> (8 * c)) & 0xffu);
}

// acc += part · scale (the segment's scale row, 4 bf16), once; part := 0
template <int TM>
__device__ __forceinline__ void gemv_scale_add(float (&acc)[TM][4], float (&part)[TM][4], uint2 s) {
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[m][c] = fmaf(part[m][c], bf16x4_at(s, c), acc[m][c]);
      part[m][c] = 0.f;
    }
}

// gs[m] += Σ of bf16 x over chunk rows row0 .. row0+n-1 (n ≤ 32), to every lane
template <int TM>
__device__ __forceinline__ void gemv_xsum(float (&gs)[TM], const __nv_bfloat16* xc, int xk,
                                          int row0, int n, int lane) {
#pragma unroll
  for (int m = 0; m < TM; ++m)
    gs[m] += warp_sum(lane < n ? __bfloat162float(xc[m * xk + row0 + lane]) : 0.f);
}

// Step j of one chunk of the group-factored function for this lane's 4
// columns (arguments as gemv_step's): per segment (the step's slots that
// share one scale row), part = Σ bf16(x) · value in f32, then acc += part ·
// scale once; then, per segment, acc −= (Σ bf16(x)) · minus_eff, minus_eff
// the minus row or scale · bias. The segments of step j, in order:
//   wide     rows 64j + g0 .. + min(G, 64), g0 = 0, min(G, 64), ...
//   crumb    G ≤ 32: field f's rows 64f + 16j .. + 16, f = 0..3; G = 256:
//            all 64 slots (the chunk's one scale row)
//   half256  rows 32j .. 32j+31 (group j), 128 + 32j .. (group 4 + j)
//   half32   units 2j and 2j + 1, rows 32u .. 32u+31 (group u)
// A 2-bit step at TM ≤ 2 holds its four fields' parts at once (each packed
// row read once from the ring); from TM = 4 it reads its packed rows once
// per field (the four parts would hold 12·TM more registers a lane).
template <int TM, class P>
__device__ __forceinline__ void gemv_grouped_step(float (&acc)[TM][4], const char* st,
                                                  const __nv_bfloat16* xc, int xk, int j,
                                                  int lane, const float* lut) {
  using S = GemvStage<P>;
  using O = TcOrder<P>;
  constexpr int G = P::G;
  constexpr bool kMinusEff = P::has_minus || P::map == kBias;
  const uint8_t* cs = reinterpret_cast<const uint8_t*>(st) + 4 * lane;
  const uint8_t* hs = reinterpret_cast<const uint8_t*>(st + S::qh_off) + 4 * lane;
  const __nv_bfloat16* ss = reinterpret_cast<const __nv_bfloat16*>(st + S::scale_off) + 4 * lane;
  const __nv_bfloat16* ms = reinterpret_cast<const __nv_bfloat16*>(st + S::minus_off) + 4 * lane;
  auto word = [](const uint8_t* base, int row) {
    return *reinterpret_cast<const uint32_t*>(base + row * kGemvBN);
  };
  auto scales = [](const __nv_bfloat16* base, int g) {
    return *reinterpret_cast<const uint2*>(base + g * kGemvBN);
  };
  // acc −= gs · minus_eff of chunk group g
  auto minus_eff = [&](const float (&gs)[TM], int g) {
    const uint2 w = scales(P::has_minus ? ms : ss, g);
    float me[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) me[c] = P::has_minus ? bf16x4_at(w, c) : bf16x4_at(w, c) * (float)P::bias;
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(-gs[m], me[c], acc[m][c]);
  };
  float part[TM][4];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[m][c] = 0.f;

  if constexpr (P::layout == kWide) {
    constexpr int GW = G < 64 ? G : 64;
    auto two_rows = [&](int row) {
      float v0[4], v1[4];
      gemv_v4_wide(word(cs, row), v0);
      gemv_v4_wide(word(cs, row + 1), v1);
      gemv_fma2<TM>(part, xc + row, xk, v0, v1);
    };
#pragma unroll 1
    for (int g0 = 0; g0 < 64; g0 += GW) {
      if constexpr (TM >= 4) {  // as gemv_step: unrolled 4, TM 4 and 8 spill
#pragma unroll 2
        for (int r = 0; r < GW; r += 2) two_rows(64 * j + g0 + r);
      } else {
#pragma unroll 4
        for (int r = 0; r < GW; r += 2) two_rows(64 * j + g0 + r);
      }
      gemv_scale_add<TM>(acc, part, scales(ss, (64 * j + g0) / G));
    }
  } else if constexpr (O::crumb) {
    // field f of packed rows 16j + r is chunk row 64f + 16j + r; its third
    // bit is bit 2f + j/2 of qh row (16j + r) % 32
    auto field = [&](int f) {
#pragma unroll 2
      for (int r = 0; r < 16; r += 2) {
        uint32_t h0 = 0u, h1 = 0u;
        if constexpr (P::has_qh) {
          h0 = word(hs, (16 * j + r) % 32);
          h1 = word(hs, (16 * j + r + 1) % 32);
        }
        float v0[4], v1[4];
        gemv_v4<P, 2>(word(cs, 16 * j + r), 2 * f, h0, 2 * f + (j >> 1), lut, v0);
        gemv_v4<P, 2>(word(cs, 16 * j + r + 1), 2 * f, h1, 2 * f + (j >> 1), lut, v1);
        gemv_fma2<TM>(part, xc + 64 * f + 16 * j + r, xk, v0, v1);
      }
    };
    if constexpr (G == kQmmChunk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) field(f);
      gemv_scale_add<TM>(acc, part, scales(ss, 0));
      if constexpr (kMinusEff) {
        float gs[TM] = {};
#pragma unroll
        for (int f = 0; f < 4; ++f) gemv_xsum<TM>(gs, xc, xk, 64 * f + 16 * j, 16, lane);
        minus_eff(gs, 0);
      }
    } else {
      if constexpr (TM <= 2) {
        float parts[4][TM][4] = {};
#pragma unroll 2
        for (int r = 0; r < 16; r += 2) {
          const uint32_t q0 = word(cs, 16 * j + r), q1 = word(cs, 16 * j + r + 1);
          uint32_t h0 = 0u, h1 = 0u;
          if constexpr (P::has_qh) {
            h0 = word(hs, (16 * j + r) % 32);
            h1 = word(hs, (16 * j + r + 1) % 32);
          }
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            float v0[4], v1[4];
            gemv_v4<P, 2>(q0, 2 * f, h0, 2 * f + (j >> 1), lut, v0);
            gemv_v4<P, 2>(q1, 2 * f, h1, 2 * f + (j >> 1), lut, v1);
            gemv_fma2<TM>(parts[f], xc + 64 * f + 16 * j + r, xk, v0, v1);
          }
        }
#pragma unroll
        for (int f = 0; f < 4; ++f)
          gemv_scale_add<TM>(acc, parts[f], scales(ss, (64 * f + 16 * j) / G));
      } else {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          field(f);
          gemv_scale_add<TM>(acc, part, scales(ss, (64 * f + 16 * j) / G));
        }
      }
      if constexpr (kMinusEff) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          float gs[TM] = {};
          gemv_xsum<TM>(gs, xc, xk, 64 * f + 16 * j, 16, lane);
          minus_eff(gs, (64 * f + 16 * j) / G);
        }
      }
    }
  } else if constexpr (O::half256) {
    // packed rows 32j + r: chunk rows 32j + r (low nibble, group j) and
    // 128 + 32j + r (high nibble, group 4 + j); fifth bits j and 4 + j of
    // qh row r
    float hi[TM][4];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) hi[m][c] = 0.f;
#pragma unroll 2
    for (int r = 0; r < 32; r += 2) {
      const uint32_t q0 = word(cs, 32 * j + r), q1 = word(cs, 32 * j + r + 1);
      uint32_t h0 = 0u, h1 = 0u;
      if constexpr (P::has_qh) {
        h0 = word(hs, r);
        h1 = word(hs, r + 1);
      }
      float lo0[4], lo1[4], hi0[4], hi1[4];
      gemv_v4<P, 4>(q0, 0, h0, j, lut, lo0);
      gemv_v4<P, 4>(q1, 0, h1, j, lut, lo1);
      gemv_v4<P, 4>(q0, 4, h0, j + 4, lut, hi0);
      gemv_v4<P, 4>(q1, 4, h1, j + 4, lut, hi1);
      gemv_fma2<TM>(part, xc + 32 * j + r, xk, lo0, lo1);
      gemv_fma2<TM>(hi, xc + 128 + 32 * j + r, xk, hi0, hi1);
    }
    gemv_scale_add<TM>(acc, part, scales(ss, j));
    gemv_scale_add<TM>(acc, hi, scales(ss, 4 + j));
    if constexpr (kMinusEff) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float gs[TM] = {};
        gemv_xsum<TM>(gs, xc, xk, 128 * g + 32 * j, 32, lane);
        minus_eff(gs, 4 * g + j);
      }
    }
  } else {
    // U = 32: units u = 2j, 2j + 1, packed rows 16u + r: chunk rows 32u + r
    // (low nibble) and 32u + 16 + r (high), both group u; fifth bits: bits
    // r/4 and 4 + r/4 of qh row 4u + r % 4
#pragma unroll 1
    for (int uu = 0; uu < 2; ++uu) {
      const int u = 2 * j + uu;
#pragma unroll 2
      for (int r = 0; r < 16; r += 2) {
        const uint32_t q0 = word(cs, 16 * u + r), q1 = word(cs, 16 * u + r + 1);
        uint32_t h0 = 0u, h1 = 0u;
        if constexpr (P::has_qh) {
          h0 = word(hs, 4 * u + r % 4);
          h1 = word(hs, 4 * u + (r + 1) % 4);
        }
        float lo0[4], lo1[4], hi0[4], hi1[4];
        gemv_v4<P, 4>(q0, 0, h0, r / 4, lut, lo0);
        gemv_v4<P, 4>(q1, 0, h1, (r + 1) / 4, lut, lo1);
        gemv_v4<P, 4>(q0, 4, h0, 4 + r / 4, lut, hi0);
        gemv_v4<P, 4>(q1, 4, h1, 4 + (r + 1) / 4, lut, hi1);
        gemv_fma2<TM>(part, xc + 32 * u + r, xk, lo0, lo1);
        gemv_fma2<TM>(part, xc + 32 * u + 16 + r, xk, hi0, hi1);
      }
      gemv_scale_add<TM>(acc, part, scales(ss, u));
    }
    if constexpr (kMinusEff) {
#pragma unroll
      for (int uu = 0; uu < 2; ++uu) {
        float gs[TM] = {};
        gemv_xsum<TM>(gs, xc, xk, 32 * (2 * j + uu), 32, lane);
        minus_eff(gs, 2 * j + uu);
      }
    }
  }
}

// After a block of a split output has written its partials: whether it is
// the last of the gridDim.z blocks that `counter` counts (block-uniform);
// that block sees every split's partials. The caller resets the counter.
__device__ __forceinline__ bool gemv_last_block(int* counter, int* flag) {
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == (int)gridDim.z - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();  // the last block: every split's partials are visible
  return true;
}

// out[row, n] = the partials [split, R, N] of (row, n) summed in split
// order, rounded once to bf16
__device__ __forceinline__ void gemv_sum_splits(const float* __restrict__ partial,
                                                __nv_bfloat16* __restrict__ out, size_t row,
                                                int R, int N, int n) {
  float s = 0.f;
#pragma unroll 8
  for (int z = 0; z < (int)gridDim.z; ++z) s += __ldcg(partial + ((size_t)z * R + row) * N + n);
  out[row * N + n] = __float2bfloat16_rn(s);
}

// The rows of x [R, K] (and of the output [R, N]) that a block's TM rows
// take, row m where has(m); the others read zeros and are not written.
// The 2-D product's are m0 + m below M, the gather's a slot list in shared
// memory.
struct ContiguousRows {
  int m0, M;
  __device__ __forceinline__ bool has(int m) const { return m0 + m < M; }
  __device__ __forceinline__ int operator[](int m) const { return m0 + m; }
};
struct SlotRows {
  const int* list;
  int count;
  __device__ __forceinline__ bool has(int m) const { return m < count; }
  __device__ __forceinline__ int operator[](int m) const { return list[m]; }
};

// One row tile of the block: the rows `rows` of x [R, K] times the [K, N]
// weight whose planes start at codes, qh, scale and minus (an expert's
// planes: the stack's base offset by the expert), for columns blockIdx.x ·
// 128 .. and chunks [blockIdx.z · per, +per); materialized weights (qmm) or
// the group-factored function (Grouped). Unsplit (gridDim.z == 1) it writes
// out [R, N] in bf16, else partial [split, R, N] in f32; then, with
// Finish, the last block of the tile's group of split blocks (counters[
// blockIdx.y · gridDim.x + blockIdx.x], 0 before and after) sums the tile's
// rows; without, the caller sums them later (gemv_last_block,
// gemv_sum_splits). The 2-D kernel ran slower at one row on the card with
// its finish after the body, or with the flag's address taken at the
// finish rather than here: the compiler then derived the shared window's
// base anew at every copy loop of the kernel. smem:
// gemv_smem_bytes<F>(XR · per · 512), x of XR ≥ TM rows at the ring's end,
// then the code table (gemv_lut), which the tile fills. A second tile of the
// same block starts after a __syncthreads (this one reads its sums from the
// ring at the end).
template <int TM, int F, bool Grouped, bool Finish, int XR, class Rows>
__device__ __forceinline__ void qmm_gemv_body(const __nv_bfloat16* __restrict__ x,
                                              const uint8_t* __restrict__ codes,
                                              const uint8_t* __restrict__ qh,
                                              const __nv_bfloat16* __restrict__ scale,
                                              const __nv_bfloat16* __restrict__ minus,
                                              __nv_bfloat16* __restrict__ out,
                                              float* __restrict__ partial,
                                              int* __restrict__ counters, Rows rows, int R,
                                              int K, int N, int chunks_per_split, char* smem) {
  static_assert(TM <= XR, "x holds the tile's rows");
  using P = QmmFormat<F>;
  using S = GemvStage<P>;
  const int xk = chunks_per_split * kQmmChunk;  // bf16 an x row in shared memory
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + S::ring);
  float* lut = gemv_lut<P>(smem, XR * xk * 2);
  [[maybe_unused]] int* flag = gemv_flag(lut);  // here, not at the finish: see above
  if constexpr (P::table) qmm_fill_table<P>(lut);  // visible after the first barrier
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kGemvBN;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int nch = min(K / kQmmChunk, c_begin + chunks_per_split) - c_begin;
  const bool vec16 = N % 16 == 0;
  const int cols = min(kGemvBN, N - n0);  // columns in range (a multiple of 4)

  // the rows' x over the block's K range; rows past the map's zero
  for (int i = tid; i < TM * (xk / 8); i += kGemvThreads) {
    const int m = i / (xk / 8), o = (i % (xk / 8)) * 8;
    const bool ok = rows.has(m) && o < nch * kQmmChunk;
    cp_async16(xs + m * xk + o,
               ok ? x + (size_t)rows[m] * K + (size_t)c_begin * kQmmChunk + o : x, ok ? 16 : 0);
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
    const char* st = smem + (i % S::stages) * S::bytes;
    if constexpr (Grouped)
      gemv_grouped_step<TM, P>(acc, st, xs + i * kQmmChunk, xk, warp, lane, lut);
    else
      gemv_step<TM, P>(acc, st, xs + i * kQmmChunk, xk, warp, lane, lut);
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
    for (int w = 1; w < 4; ++w) v[m] += red[(w * TM + m) * kGemvBN + tid];  // in warp order
  }
  if (gridDim.z == 1) {
    if (n < N) {
#pragma unroll
      for (int m = 0; m < TM; ++m)
        if (rows.has(m)) out[(size_t)rows[m] * N + n] = __float2bfloat16_rn(v[m]);
    }
    return;
  }
  if (n < N) {
#pragma unroll
    for (int m = 0; m < TM; ++m)
      if (rows.has(m)) partial[((size_t)blockIdx.z * R + rows[m]) * N + n] = v[m];
  }
  if constexpr (Finish) {
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
        if (!rows.has(m)) break;
        float sum = 0.f;
#pragma unroll 8
        for (int z = 0; z < (int)gridDim.z; ++z)  // in split order
          sum += __ldcg(partial + ((size_t)z * R + rows[m]) * N + n);
        out[(size_t)rows[m] * N + n] = __float2bfloat16_rn(sum);
      }
    }
    if (tid == 0) *counter = 0;  // ready for the next launch
  }
}

}  // namespace tpullm
