// The dequantize×matmul device body on the tensor cores, shared by qmm.cu
// (one weight, M ≥ 16) and qmm_moe.cu (expert stacks).
//
// It replaces, at prefill, tpullm/ops/pallas/qmm.py::_kernel_mat + _acc_tile
// (the 2-D pallas_call in _qmm_2d; below 16 rows qmm_gemv.cuh does) and
// _kernel_stack (_qmm_stack), and computes _acc_tile's function
// with its rounding points, that of ops/kernels/qmm.py::qmm_reference:
//
//   y[m, n] = Σ_k bf16(x[m,k]) · bf16(f32(map(code[k,n])) · f32(scale[k/G, n]))
//             − Σ_g (Σ_{k∈g} bf16(x[m,k])) · minus[g, n]      (f32 sums, bf16 out)
//
// What bounds it on the card: at M = 512 the tensor-core product, 2·M·K·N
// (8B gate_up: 120 GFLOP, 0.12 ms at 989 TFLOP/s), and the decode of every
// weight once per 128 rows of x. What the design does about that:
// - A block computes a 128 × 128 output tile with 8 warps, each a 64 × 32
//   slab of f32 accumulators, through mma.sync m16n8k16 (bf16 in, f32 sums)
//   with ldmatrix (.trans for the weight tile). A weight is decoded once per
//   128 rows of x (4 times at M = 512, where the CUDA-core body decodes it 32
//   times) and multiplied on the tensor cores.
// - K advances 64 rows (a "step") at a time through each 256-row chunk. A
//   step's 64 slots are rows of the chunk in runs (TcOrder), chosen so that
//   a step reads whole packed bytes: a U = 256 half-split step takes packed
//   rows 32j .. 32j+31 (both nibbles: chunk rows 32j.. and 128+32j..), a
//   2-bit step packed rows 16j .. 16j+15 (all four fields). x is copied in
//   the same slot order, so the product is unchanged. Runs are 16, 32 or 64
//   rows, multiples of every G in {16, 32} and whole inside a G = 256 group,
//   so scale groups and split units stay whole.
// - Two blocks an SM (launch bounds: at most 128 registers a thread, no
//   spills; shared memory 88–113 KB a block, the whole SM's preferred over
//   L1): one block's decode and barriers overlap the other's products. In
//   a comparison on the card two blocks beat one block an SM (a 4-stage
//   ring, up to 223 registers) on every shape and format compared.
// - x: cp.async 16-byte copies of the [128, 64] bf16 tile into a 3-stage
//   ring in shared memory, rows past M zero-filled; a step's copies are
//   issued two steps ahead.
// - The weight tile: all 256 threads decode the step's [64, 128] slice of
//   the packed planes into bf16 in shared memory, rounding once after the
//   scale multiply, through the QmmFormat<F> traits and the code tables of
//   qmm_body.cuh (16 f32 values in shared memory). The identity and bias
//   maps go two columns at a time as bf16 pairs (codes_times_scales: one
//   bf16 multiply rounds the exact product, the f32 path's result to the
//   bit); the code tables and the wide layouts multiply in f32. A warp reads 128
//   contiguous plane bytes per packed row. The next step's plane words are
//   loaded into registers before this step's products and decoded after
//   them, into the other of two weight buffers, so the loads' latency hides
//   behind the tensor-core work.
// - Tiles are padded (x rows 72 bf16, weight rows 136) so that the 8 rows an
//   ldmatrix reads fall in 8 distinct bank groups.
// - The minus term (Q4_K, Q5_K, Q4_1, Q5_1, Q2_K): per step, f32 sums of
//   bf16 x over each run of slots that shares one minus row (gsum, [128,
//   ≤ 4]), and acc -= gsum · minus in f32 on the accumulators. The M·N·K/G
//   products go to the tensor cores, not to CUDA-core FMAs: each f32 gsum
//   is split exactly into three bf16 terms (hi + lo + lo2 = gsum: 24 bits of
//   significand in three 8-bit pieces), minus is exact in bf16, so one more
//   m16n8k16 product a step, [128, 16] × [16, 128] with rows 3·seg + part,
//   adds −gsum·minus with exact products and f32 sums. gsum stays f32 and
//   the weight never absorbs the minus (that would move a rounding point
//   away from _acc_tile). Done on CUDA cores, these FMAs doubled the time of
//   the minus formats at M = 512.
// - K split over blockIdx.z into f32 partials summed in split order by
//   qmm_reduce (deterministic, no atomics), when the output tiles alone are
//   too few to fill the card (ops/kernels/qmm.py plan()).
// Not done here: wgmma with a TMA producer warp, the design that reaches the
// card's full tensor rate (ROADMAP 2b).
//
// The grouped form (Grouped = true: qmm.cu qmm_grouped_tc_kernel) computes,
// on the same tiles, ring and decode, the group-factored function of
// tpullm/ops/pallas/qmm.py::_kernel, that of ops/kernels/qmm.py::
// qmm_grouped_reference:
//
//   y[m, n] = Σ_g scale[g, n] · (Σ_{k∈g} bf16(x[m,k]) · value(k, n))
//             − Σ_g minus_eff[g, n] · (Σ_{k∈g} bf16(x[m,k]))     (f32 sums, bf16 out)
//
// value the raw code of the identity and bias maps, the table value or the
// signed byte (each exact in bf16), minus_eff the minus plane or scale·bias.
// What changes:
// - The weight tile holds the unscaled value: no scale multiply a weight.
// - Each step's scale rows go to shared memory as f32 [NGSEG, 128] beside
//   the weight tile, loaded one step ahead with the plane words. A scale
//   segment is GSEG ≤ 32 slots that share one scale row (TcOrder): for
//   each, a fresh f32 fragment takes the segment's one or two k16 products
//   and acc += fragment · scale, one FMA an element. The loop holds one
//   (m-tile, n-tile) fragment at a time, the segment's B fragments and one
//   m-tile's A: about 100 registers under the launch bound of 128 (at 64
//   slots a segment it would be about 124, so G = 256's one scale row a
//   step is taken in two pieces of 32), and takes the step's segments one
//   at a time (unrolled, the compiler interleaved them and spilled, and
//   ran slower on the card). The M·N·K/GSEG FMAs run on the CUDA cores
//   beside the tensor-core products. One block an SM with up to 255
//   registers, and a fragment for the whole 64 × 32 slab, were both slower
//   on the card.
// - The minus term is the split-gsum product above with minus_eff: the
//   minus plane, or scale·bias for the bias maps (Q4_0, Q5_0, Q3_K, TQ1_0,
//   TQ2_0: bias a power of two, so exact in bf16), whose bias the
//   materializing form folds into the weight.
#pragma once

#include "qmm_body.cuh"

namespace tpullm {

constexpr int kTcThreads = 256;  // 8 warps: 2 along M × 4 along N
constexpr int kTcBlocksPerSm = 2;  // the launch bounds: at most 128 registers a thread
constexpr int kTcBM = 128;       // rows of x per block
constexpr int kTcBN = 128;       // output columns per block
constexpr int kTcBK = 64;        // K slots per step; 4 steps per 256-row chunk
constexpr int kTcStages = 3;     // depth of the x ring
constexpr int kTcXPitch = kTcBK + 8;  // bf16 per x row in shared memory
constexpr int kTcWPitch = kTcBN + 8;  // bf16 per weight row in shared memory
constexpr int kTcMPitch = 16 + 8;     // bf16 per row of the split gsum tile
constexpr int kTcSteps = kQmmChunk / kTcBK;

// Slot s of step j (0..3) of a chunk is chunk row (s / RUN)·STRIDE + RUN·j +
// s % RUN: the half-split U = 256 layouts two runs of 32 (the low and the high
// nibbles of packed rows 32j..32j+31), the 2-bit layouts four runs of 16 (the
// four fields of packed rows 16j..16j+15), every other layout one run of 64.
// A minus segment is SEG slots that share one minus row; a scale segment of
// the grouped form GSEG slots that share one scale row (SEG, or 32 where the
// whole step shares one: G = 256).
template <class P>
struct TcOrder {
  static constexpr bool crumb = P::layout == kCrumb || P::layout == kCrumbQh;
  static constexpr bool half256 = (P::layout == kHalf || P::layout == kHalfQh) && P::U == 256;
  static constexpr int RUN = crumb ? 16 : half256 ? 32 : 64;
  static constexpr int STRIDE = crumb ? 64 : half256 ? 128 : 64;
  static constexpr int SEG = P::G < RUN ? P::G : RUN;
  static constexpr int NSEG = kTcBK / SEG;
  static constexpr int GSEG = P::G >= kTcBK ? 32 : SEG;
  static constexpr int NGSEG = kTcBK / GSEG;
  static_assert(!half256 || P::G == 32, "the U = 256 half-split formats have G = 32");
  static_assert(GSEG == 16 || GSEG == 32, "a scale segment is one or two k16 slices");
  __device__ static int row(int j, int s) { return (s / RUN) * STRIDE + RUN * j + s % RUN; }
};

// Whether the body applies a minus term: the minus formats, and in the
// grouped form the bias maps too (minus_eff = scale · bias).
template <class P, bool Grouped>
__host__ __device__ constexpr bool tc_minus() {
  return P::has_minus || (Grouped && P::map == kBias);
}

// Shared memory of one block: the x ring, two weight tiles, two split-gsum
// [128, 16] and two minus [16, 128] tiles (tc_minus), two f32 scale tiles
// [NGSEG, 128] (grouped), the code table.
template <int F, bool Grouped>
constexpr int qmm_tc_smem_bytes() {
  using P = QmmFormat<F>;
  return kTcStages * kTcBM * kTcXPitch * 2 + 2 * kTcBK * kTcWPitch * 2 +
         (tc_minus<P, Grouped>() ? 2 * (kTcBM * kTcMPitch + 16 * kTcWPitch) * 2 : 0) +
         (Grouped ? 2 * TcOrder<P>::NGSEG * kTcBN * 4 : 0) + 16 * 4;
}

// the f32 of column c (0..3) of four bf16 held as a uint2
__device__ __forceinline__ float bf16x4_at(uint2 v, int c) {
  const uint32_t w = c < 2 ? v.x : v.y;
  return __uint_as_float((c & 1) ? (w & 0xffff0000u) : (w << 16));
}

// four weights rounded once to bf16, stored as 8 bytes
__device__ __forceinline__ void st_bf16x4(__nv_bfloat16* p, const float (&w)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(w[0], w[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(w[2], w[3]);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two codes (the low bits of each 16-bit half of `pair`, < 128) of an
// identity or bias map times their two bf16 scales, each rounded once to
// bf16: the code goes into the mantissa of bf16 128.0 (128 + code, exact),
// 128 + bias comes off (exact), and one bf16 multiply rounds the exact
// product, |code − bias| · scale (≤ 5 + 8 significant bits), as the f32
// multiply and its rounding to bf16 do.
template <class P>
__device__ __forceinline__ uint32_t codes_times_scales(uint32_t pair, uint32_t scales) {
  constexpr uint32_t kMagic = 0x43004300u;  // bf16 128.0 in each half
  constexpr uint32_t kBiasBits = P::map == kBias ? (uint32_t)P::bias * 0x00010001u : 0u;
  const __nv_bfloat162 v = __hsub2(as_bf162(pair | kMagic), as_bf162(kMagic | kBiasBits));
  return as_u32(__hmul2(v, as_bf162(scales)));
}

// The tile's two bf16 of a code pair: times their scales (codes_times_scales)
// or, in the grouped form, the raw codes (exact: 128 + code − 128)
template <class P, bool Grouped>
__device__ __forceinline__ uint32_t tc_pair(uint32_t pair, uint32_t scales) {
  constexpr uint32_t kMagic = 0x43004300u;
  if constexpr (Grouped) return as_u32(__hsub2(as_bf162(pair | kMagic), as_bf162(kMagic)));
  else return codes_times_scales<P>(pair, scales);
}

// One thread's share of a step's weight tile: 8 slots × its 4 columns (the
// warp's 32 lanes cover the tile's 128 columns). Plane words are loaded by
// load() and decoded into the tile by store(), with other work between. The
// grouped form loads no scales and stores the unscaled values.
//   wide    8 code rows, slots 8w .. 8w+7, one scale group
//   half32  4 packed rows 4w .. 4w+3 of the step's 32 (unit w/4), slots
//           32u + r and 32u + 16 + r, one scale group (G = U = 32)
//   half256 4 packed rows 4w .. 4w+3 of 32j .. 32j+31, slots r and 32 + r,
//           scale groups j and 4 + j
//   crumb   2 packed rows 2w, 2w+1 of 16j .. 16j+15, slots 16f + r for the
//           four fields f, one scale group per field (one for G = 256)
template <class P, bool Grouped>
struct TcDecode {
  using O = TcOrder<P>;
  static constexpr bool wide = P::layout == kWide;
  static constexpr int NQ = wide ? 8 : O::crumb ? 2 : 4;
  static constexpr int NS = O::crumb ? (P::G == 256 ? 1 : 4) : O::half256 ? 2 : 1;
  uint32_t q[NQ];
  uint32_t h[P::has_qh ? NQ : 1];
  uint2 sc[NS];

  // a decoded value in f32 times its column's scale (the grouped form: as is)
  static __device__ __forceinline__ float scaled(float v, uint2 s, int c) {
    if constexpr (Grouped) return v;
    else return v * bf16x4_at(s, c);
  }

  __device__ __forceinline__ void load(const uint8_t* __restrict__ codes,
                                       const uint8_t* __restrict__ qh,
                                       const __nv_bfloat16* __restrict__ scale, int N, int k0,
                                       int j, int n, int w) {
    constexpr int G = P::G;
    if constexpr (wide) {
      const uint8_t* c = codes + (size_t)(k0 + 64 * j + 8 * w) * N + n;
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = __ldg(reinterpret_cast<const uint32_t*>(c + (size_t)i * N));
      if constexpr (!Grouped)
        sc[0] = __ldg(reinterpret_cast<const uint2*>(scale + (size_t)((k0 + 64 * j + 8 * w) / G) * N + n));
    } else if constexpr (O::crumb) {
      const int p = 16 * j + 2 * w;  // chunk-local packed row
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        q[i] = __ldg(reinterpret_cast<const uint32_t*>(codes + (size_t)(k0 / 4 + p + i) * N + n));
        if constexpr (P::has_qh)
          h[i] = __ldg(reinterpret_cast<const uint32_t*>(qh + (size_t)(k0 / 8 + (p + i) % 32) * N + n));
      }
#pragma unroll
      for (int f = 0; f < (Grouped ? 0 : NS); ++f)
        sc[f] = __ldg(reinterpret_cast<const uint2*>(scale + (size_t)((k0 + 64 * f + p) / G) * N + n));
    } else if constexpr (O::half256) {
      const int p = 32 * j + 4 * w;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q[i] = __ldg(reinterpret_cast<const uint32_t*>(codes + (size_t)(k0 / 2 + p + i) * N + n));
        if constexpr (P::has_qh)  // qh row of chunk row 32j + r (and 128 + 32j + r): r
          h[i] = __ldg(reinterpret_cast<const uint32_t*>(qh + (size_t)(k0 / 8 + 4 * w + i) * N + n));
      }
      if constexpr (!Grouped) {
        sc[0] = __ldg(reinterpret_cast<const uint2*>(scale + (size_t)(k0 / G + j) * N + n));
        sc[1] = __ldg(reinterpret_cast<const uint2*>(scale + (size_t)(k0 / G + 4 + j) * N + n));
      }
    } else {  // half-split U = 32: step j holds units 2j, 2j + 1
      const int u = w / 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q[i] = __ldg(reinterpret_cast<const uint32_t*>(codes + (size_t)(k0 / 2 + 32 * j + 4 * w + i) * N + n));
        if constexpr (P::has_qh)  // qh rows 4 per unit; row r % 4 = i
          h[i] = __ldg(reinterpret_cast<const uint32_t*>(qh + (size_t)(k0 / 8 + 8 * j + 4 * u + i) * N + n));
      }
      if constexpr (!Grouped)
        sc[0] = __ldg(reinterpret_cast<const uint2*>(scale + (size_t)((k0 + 64 * j + 32 * u) / G) * N + n));
    }
  }

  // decodes into the weight tile ws [64][kTcWPitch] at columns 4·lane ..;
  // `on` false (columns past N) writes zeros
  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ ws, const float* lut, int j,
                                        int lane, int w, bool on) const {
    __nv_bfloat16* col = ws + 4 * lane;
    float v[4];
    if (!on) {  // the 8 warps' lanes of these columns zero slots 8w .. 8w+7: all 64
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = 0.f;
#pragma unroll
      for (int s = 0; s < 8; ++s) st_bf16x4(col + (size_t)(8 * w + s) * kTcWPitch, v);
      return;
    }
    if constexpr (wide) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[c] = scaled((float)(int8_t)((q[i] >> (8 * c)) & 0xffu), sc[0], c);
        st_bf16x4(col + (size_t)(8 * w + i) * kTcWPitch, v);
      }
    } else if constexpr (O::crumb) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const uint2 s = sc[NS == 1 ? 0 : f];
          __nv_bfloat16* dst = col + (size_t)(16 * f + 2 * w + i) * kTcWPitch;
          if constexpr (!P::table) {  // columns (0, 1) and (2, 3) as bf16 pairs
            uint2 out;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const uint32_t sel = k ? 0x4342u : 0x4140u;  // bytes 2k, 2k+1 into the halves
              uint32_t pair = (__byte_perm(q[i], 0, sel) >> (2 * f)) & 0x00030003u;
              if constexpr (P::has_qh)
                pair |= ((__byte_perm(h[i], 0, sel) >> (2 * f + (j >> 1))) & 0x00010001u) << 2;
              (k ? out.y : out.x) = tc_pair<P, Grouped>(pair, k ? s.y : s.x);
            }
            *reinterpret_cast<uint2*>(dst) = out;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              uint32_t code = (q[i] >> (8 * c + 2 * f)) & 3u;
              if constexpr (P::has_qh) code |= ((h[i] >> (8 * c + 2 * f + (j >> 1))) & 1u) << 2;
              v[c] = scaled(qmm_value<P>(code, lut), s, c);
            }
            st_bf16x4(dst, v);
          }
        }
      }
    } else {
      // half-split: packed row i gives a low-nibble and a high-nibble slot
      constexpr bool h256 = O::half256;
      const uint2 s_lo = sc[0], s_hi = sc[h256 ? 1 : 0];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hbit = h256 ? j : (w & 3);  // the fifth bit of the low row; +4 for the high
        const int r = 4 * w + i;  // h256: 0..31; else unit w/4, row r % 16 of it
        const int slot_lo = h256 ? r : 32 * (w / 4) + r % 16;
        const int slot_hi = h256 ? 32 + r : slot_lo + 16;
        if constexpr (!P::table) {  // columns (0, 1) and (2, 3) as bf16 pairs
          uint2 lo, up;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const uint32_t sel = k ? 0x4342u : 0x4140u;  // bytes 2k, 2k+1 into the halves
            const uint32_t b = __byte_perm(q[i], 0, sel);
            uint32_t c_lo = b & 0x000f000fu, c_up = (b >> 4) & 0x000f000fu;
            if constexpr (P::has_qh) {
              const uint32_t hb = __byte_perm(h[i], 0, sel);
              c_lo |= ((hb >> hbit) & 0x00010001u) << 4;
              c_up |= ((hb >> (hbit + 4)) & 0x00010001u) << 4;
            }
            (k ? lo.y : lo.x) = tc_pair<P, Grouped>(c_lo, k ? s_lo.y : s_lo.x);
            (k ? up.y : up.x) = tc_pair<P, Grouped>(c_up, k ? s_hi.y : s_hi.x);
          }
          *reinterpret_cast<uint2*>(col + (size_t)slot_lo * kTcWPitch) = lo;
          *reinterpret_cast<uint2*>(col + (size_t)slot_hi * kTcWPitch) = up;
        } else {
          float hi[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t byte = (q[i] >> (8 * c)) & 0xffu;
            uint32_t lo = byte & 0xfu, up = byte >> 4;
            if constexpr (P::has_qh) {
              const uint32_t hb = (h[i] >> (8 * c)) & 0xffu;
              lo |= ((hb >> hbit) & 1u) << 4;
              up |= ((hb >> (hbit + 4)) & 1u) << 4;
            }
            v[c] = scaled(qmm_value<P>(lo, lut), s_lo, c);
            hi[c] = scaled(qmm_value<P>(up, lut), s_hi, c);
          }
          st_bf16x4(col + (size_t)slot_lo * kTcWPitch, v);
          st_bf16x4(col + (size_t)slot_hi * kTcWPitch, hi);
        }
      }
    }
  }
};

// The launch attributes of a tensor-core kernel: its dynamic shared memory,
// and the whole of an SM's shared memory preferred over L1, so that the
// blocks the kernel's launch bounds allow fit on one SM.
template <class Kernel>
inline cudaError_t qmm_tc_attributes(Kernel* kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// the f32 v as three bf16 terms whose sum is exactly v
__device__ __forceinline__ void split3_bf16(float v, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(t[0]);
  t[1] = __float2bfloat16_rn(r1);
  t[2] = __float2bfloat16_rn(r1 - __bfloat162float(t[1]));
}

// acc[4][4] += a (rows of this warp's slab) · b (16 × 128 tile, the warp's 32
// columns), one k16 step from shared memory
__device__ __forceinline__ void mma_k16(float (&acc)[4][4][4], const __nv_bfloat16* a_tile,
                                        int a_pitch, const __nv_bfloat16* b_tile, int lane,
                                        int wm, int wn) {
  uint32_t b[4][2];
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, b_tile + (size_t)(lane & 15) * kTcWPitch + wn * 32 + np * 16 + (lane >> 4) * 8);
    b[2 * np][0] = r[0];
    b[2 * np][1] = r[1];
    b[2 * np + 1][0] = r[2];
    b[2 * np + 1][1] = r[3];
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    uint32_t a[4];
    ldmatrix_x4(a, a_tile + (size_t)(wm * 64 + mt * 16 + (lane & 15)) * a_pitch + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
  }
}

// d = a · b, one m16n8k16 tile, bf16 inputs, f32 sums, from zero
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// acc[4][4] += (a · b) ⊙ scale over KS k16 slices of one scale segment: for
// each (m-tile, n-tile) the slices' products into a fresh f32 fragment,
// then one FMA an element by its column's f32 scale (scale: the segment's
// 128 columns). Live at once: the segment's B fragments, one m-tile's A,
// one fragment and the warp's 8 column scales.
template <int KS>
__device__ __forceinline__ void mma_k16_scaled(float (&acc)[4][4][4], const __nv_bfloat16* a_tile,
                                               int a_pitch, const __nv_bfloat16* b_tile,
                                               const float* scale, int lane, int wm, int wn) {
  uint32_t b[KS][4][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, b_tile + (size_t)(ks * 16 + (lane & 15)) * kTcWPitch + wn * 32 + np * 16 +
                               (lane >> 4) * 8);
      b[ks][2 * np][0] = r[0];
      b[ks][2 * np][1] = r[1];
      b[ks][2 * np + 1][0] = r[2];
      b[ks][2 * np + 1][1] = r[3];
    }
  float2 sc[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    sc[nt] = *reinterpret_cast<const float2*>(scale + wn * 32 + nt * 8 + 2 * (lane & 3));
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    uint32_t a[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(a[ks], a_tile + (size_t)(wm * 64 + mt * 16 + (lane & 15)) * a_pitch + ks * 16 +
                             (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float t[4];
      mma_bf16_zero(t, a[0], b[0][nt][0], b[0][nt][1]);
#pragma unroll
      for (int ks = 1; ks < KS; ++ks) mma_bf16(t, a[ks], b[ks][nt][0], b[ks][nt][1]);
      acc[mt][nt][0] = fmaf(t[0], sc[nt].x, acc[mt][nt][0]);  // row lane/4, columns 2·(lane%4) + 0, 1
      acc[mt][nt][1] = fmaf(t[1], sc[nt].y, acc[mt][nt][1]);
      acc[mt][nt][2] = fmaf(t[2], sc[nt].x, acc[mt][nt][2]);  // row lane/4 + 8
      acc[mt][nt][3] = fmaf(t[3], sc[nt].y, acc[mt][nt][3]);
    }
  }
}

// x, codes, qh, scale and minus point at this block's weight and input rows;
// the block computes rows m0 .. m0+127 of x [M, K] (rows past M read as 0)
// into output rows row0 + m0 .. of R, columns n0 .. n0+127 (past N
// skipped), over the chunks of blockIdx.z. smem: qmm_tc_smem_bytes<F,
// Grouped>(). Grouped: the group-factored function (see the notes above).
template <int F, bool Grouped>
__device__ __forceinline__ void qmm_tc_body(const __nv_bfloat16* __restrict__ x,
                                            const uint8_t* __restrict__ codes,
                                            const uint8_t* __restrict__ qh,
                                            const __nv_bfloat16* __restrict__ scale,
                                            const __nv_bfloat16* __restrict__ minus,
                                            __nv_bfloat16* __restrict__ out,
                                            float* __restrict__ partial, int M, int K, int N,
                                            int R, int row0, int m0, int n0,
                                            int chunks_per_split, char* smem) {
  using P = QmmFormat<F>;
  using O = TcOrder<P>;
  constexpr int G = P::G;
  constexpr int NSEG = O::NSEG, NGSEG = O::NGSEG;
  constexpr bool kMinus = tc_minus<P, Grouped>();
  static_assert(!kMinus || 3 * NSEG <= 16, "the split gsum fits one k16 step");
  auto xs = reinterpret_cast<__nv_bfloat16(*)[kTcBM][kTcXPitch]>(smem);
  auto ws = reinterpret_cast<__nv_bfloat16(*)[kTcBK][kTcWPitch]>(smem + kTcStages * kTcBM * kTcXPitch * 2);
  char* tail = smem + kTcStages * kTcBM * kTcXPitch * 2 + 2 * kTcBK * kTcWPitch * 2;
  // kMinus: gsum split in three bf16 terms, column 3·seg + part, and
  // −minus_eff in rows 3·seg + part; the other columns and rows stay 0
  auto am = reinterpret_cast<__nv_bfloat16(*)[kTcBM][kTcMPitch]>(tail);
  auto bm = reinterpret_cast<__nv_bfloat16(*)[16][kTcWPitch]>(tail + 2 * kTcBM * kTcMPitch * 2);
  tail += kMinus ? 2 * (kTcBM * kTcMPitch + 16 * kTcWPitch) * 2 : 0;
  // grouped: the f32 scale rows of each scale segment of a step, two buffers
  auto gs = reinterpret_cast<float(*)[NGSEG][kTcBN]>(tail);
  float* lut = reinterpret_cast<float*>(tail + (Grouped ? 2 * NGSEG * kTcBN * 4 : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's 64 × 32 slab of the tile
  const int n_dec = n0 + 4 * lane;          // the columns this thread decodes
  const bool on = n_dec < N;                // N % 4 == 0: all 4 in range, or none
  if constexpr (P::table) qmm_fill_table<P>(lut);  // visible after the prologue's barrier
  if constexpr (kMinus) {  // zero both split tiles once
    const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
    for (int i = tid; i < 2 * kTcBM * kTcMPitch; i += kTcThreads) (&am[0][0][0])[i] = z;
    for (int i = tid; i < 2 * 16 * kTcWPitch; i += kTcThreads) (&bm[0][0][0])[i] = z;
  }

  const int c_begin = blockIdx.z * chunks_per_split;
  const int nsteps = kTcSteps * (min(K / kQmmChunk, c_begin + chunks_per_split) - c_begin);
  auto k0_of = [&](int s) { return (c_begin + s / kTcSteps) * kQmmChunk; };

  // x rows of step s into ring slot buf: 128 rows × 8 copies of 8 slots
  auto load_x = [&](int s, int buf) {
    const int k0 = k0_of(s), j = s % kTcSteps;
#pragma unroll
    for (int t = 0; t < kTcBM * (kTcBK / 8) / kTcThreads; ++t) {
      const int i = tid + t * kTcThreads;
      const int r = i >> 3, slot = (i & 7) * 8;
      const int m = m0 + r;
      const __nv_bfloat16* src = x + (size_t)(m < M ? m : 0) * K + k0 + O::row(j, slot);
      cp_async16(&xs[buf][r][slot], src, m < M ? 16 : 0);
    }
  };
  // per step: the minus rows of its segments (2 values a thread at most;
  // a bias map's scale rows, minus_eff = scale · bias), and in the grouped
  // form the scale rows of its scale segments (as many)
  __nv_bfloat16 mn_raw[2], sc_raw[2];
  auto load_minus = [&](int s) {
    const int k0 = k0_of(s), j = s % kTcSteps;
    if constexpr (kMinus) {
      const __nv_bfloat16* plane = P::has_minus ? minus : scale;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = tid + t * kTcThreads;
        const int seg = i / kTcBN, c = i % kTcBN;
        mn_raw[t] = (seg < NSEG && n0 + c < N)
            ? plane[(size_t)((k0 + O::row(j, seg * O::SEG)) / G) * N + n0 + c]
            : __float2bfloat16_rn(0.f);
      }
    }
    if constexpr (Grouped) {
#pragma unroll
      for (int t = 0; t < NGSEG * kTcBN / kTcThreads; ++t) {
        const int i = tid + t * kTcThreads;
        const int seg = i / kTcBN, c = i % kTcBN;
        sc_raw[t] = n0 + c < N ? scale[(size_t)((k0 + O::row(j, seg * O::GSEG)) / G) * N + n0 + c]
                               : __float2bfloat16_rn(0.f);
      }
    }
  };
  // the step's split group sums of x and its negated minus rows into buffer
  // b (and the grouped form's scale rows)
  auto prep_minus = [&](int buf, int b) {
    if constexpr (Grouped) {
#pragma unroll
      for (int t = 0; t < NGSEG * kTcBN / kTcThreads; ++t) {
        const int i = tid + t * kTcThreads;
        gs[b][i / kTcBN][i % kTcBN] = __bfloat162float(sc_raw[t]);
      }
    }
    if constexpr (kMinus) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = tid + t * kTcThreads;
        if (i < NSEG * kTcBN) {
          const __nv_bfloat16 neg = P::has_minus
              ? __hneg(mn_raw[t])
              : __float2bfloat16_rn(-__bfloat162float(mn_raw[t]) * (float)P::bias);  // exact
#pragma unroll
          for (int part = 0; part < 3; ++part) bm[b][3 * (i / kTcBN) + part][i % kTcBN] = neg;
        }
      }
      // a warp sums 32 consecutive rows of one segment; lane l starts at
      // word l / 8 of its row segment, so that the 32 lanes' loads of each
      // iteration fall in 32 distinct banks (rows 144 bytes apart repeat
      // every 8 rows)
      constexpr int W = O::SEG / 2;  // bf16 pairs a segment
#pragma unroll
      for (int t = 0; t < kTcBM * NSEG / kTcThreads; ++t) {
        const int i = tid + t * kTcThreads;
        const int r = i % kTcBM, seg = i / kTcBM;
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&xs[buf][r][seg * O::SEG]);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float2 f = __bfloat1622float2(p[(e + (lane >> 3)) % W]);
          sum += f.x;
          sum += f.y;
        }
        __nv_bfloat16 t3[3];
        split3_bf16(sum, t3);
#pragma unroll
        for (int part = 0; part < 3; ++part) am[b][r][3 * seg + part] = t3[part];
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  TcDecode<P, Grouped> dec;
  // prologue: x stages 0 .. kTcStages-2 in flight, step 0's weights decoded
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nsteps) load_x(s, s);
    cp_async_commit();
  }
  if (nsteps > 0) {
    if (on) dec.load(codes, qh, scale, N, k0_of(0), 0, n_dec, warp);
    load_minus(0);
  }
  cp_async_wait<kTcStages - 2>();
  __syncthreads();  // the table and x stage 0 are visible
  if (nsteps > 0) {
    dec.store(&ws[0][0][0], lut, 0, lane, warp, on);
    prep_minus(0, 0);
  }

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kTcStages - 3>();  // this thread's copies of stage s + 1 landed
    __syncthreads();  // step s's tiles written; step s-1's readers done with its buffers
    {
      const int t = s + kTcStages - 1;  // into the ring slot step s-1 used
      if (t < nsteps) load_x(t, t % kTcStages);
      cp_async_commit();
    }
    const bool next = s + 1 < nsteps;
    if (next) {  // the next step's plane words, in flight during the products
      if (on) dec.load(codes, qh, scale, N, k0_of(s + 1), (s + 1) % kTcSteps, n_dec, warp);
      load_minus(s + 1);
    }

    const int buf = s % kTcStages, wb = s & 1;
    if constexpr (Grouped) {  // one segment at a time: unrolled, they spill at 128 registers
#pragma unroll 1
      for (int g = 0; g < NGSEG; ++g)
        mma_k16_scaled<O::GSEG / 16>(acc, &xs[buf][0][g * O::GSEG], kTcXPitch,
                                     &ws[wb][g * O::GSEG][0], gs[wb][g], lane, wm, wn);
    } else {
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
        mma_k16(acc, &xs[buf][0][kk * 16], kTcXPitch, &ws[wb][kk * 16][0], lane, wm, wn);
    }
    if constexpr (kMinus)  // acc += split gsum · (−minus_eff)
      mma_k16(acc, &am[wb][0][0], kTcMPitch, &bm[wb][0][0], lane, wm, wn);
    if (next) {
      dec.store(&ws[wb ^ 1][0][0], lut, (s + 1) % kTcSteps, lane, warp, on);
      prep_minus((s + 1) % kTcStages, wb ^ 1);
    }
  }
  cp_async_wait<0>();

  // epilogue: bf16 pairs to out [R, N], or f32 pairs to partial [split, R, N]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm * 64 + mt * 16 + (lane >> 2) + 8 * hh;
      if (m >= M) continue;
      const size_t row = (size_t)row0 + m;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * (lane & 3);
        if (n >= N) continue;
        const float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
        if (gridDim.z == 1) {
          *reinterpret_cast<__nv_bfloat162*>(out + row * N + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * R + row) * N + n) =
              make_float2(v0, v1);
        }
      }
    }
}

}  // namespace tpullm
