// Causal online-softmax attention over the head-major KV cache, for Hopper.
//
// Replaces the TPU kernel tpullm/ops/pallas/flash.py::_make_kernel, launched
// by _run: quant=false (dense K/V, entry flash_attention: bf16, f16 or f32,
// the cache types the JAX kernel upcasts to f32 in its body) and quant=true
// (int8 K/V with one f32 scale per position, entry flash_attention_q8). Both
// kernels are templated on the cache element type KV (kKvBf16, kKvF16,
// kKvF32, kKvQ8); q and the output stay bf16. Semantics
// kept from the TPU kernel: per-batch offsets (query row t sits at position
// off + t, kv_len = off + T), GQA by h / (H / Hkv), optional softcap (tanh)
// before ALiBi slope_h · (k_pos − q_pos) and the mask, sliding window,
// per-head sink logits folded into the normalizer only, NEG_INF = -1e30 as
// the running max before any key, safe = l > 0 ? l : 1, and keys read up to
// kv_len, never S. A masked key adds exactly 0 (its score is −inf), so a
// stretch of keys that a row cannot see leaves (m, l, acc) = (−1e30, 0, 0).
//
// Two regimes, picked before the launch from the query rows that share one
// KV head, R = T · (H / Hkv) (ops/kernels/flash.py regime(), which passes
// max_splits 0 for the prefill kernel):
//
// R ≤ kDecodeRows = 16, and a decode token (T = 1) up to kDecodeMaxRows =
//   80 (decode; the 8B's T = 1 is R = 4, Falcon-7B's 71 heads on one KV
//   head R = 71): split-KV on CUDA cores, flash_decode_kernel. What bounds
//   it: the K/V bytes up to kv_len
//   (kv_len · (D + DV) · 2 bytes a KV head in bf16 and f16, twice that in
//   f32, half that plus the scales in q8). One block per (batch, KV head,
//   split, row group of 16 rows): the rows of a row group, heads of one KV
//   head, share every K/V tile,
//   so each is read once a row group (the old grid read it G times; R = 71
//   reads it five times, where the prefill kernel read it 71 times, once a
//   head). A row group changes no row's arithmetic: R ≤ 16 is one row group,
//   the kernel as it was, and each row group merges its own splits through
//   its own counter. Each batch's key
//   range [window start, kv_len) is cut into splits of whole 64-key tiles (kv_split, mirrored by
//   ops/kernels/flash.py kv_splits): as many as max_splits, which the
//   wrapper sizes so that B · Hkv · max_splits blocks cover the card about
//   twice; a short context gets fewer (kv_len 38 one, kv_len 3001 sixteen,
//   at B = 2, Hkv = 8). Splits of 16 or 32 keys were tried on the card and
//   lost: below a tile the merge they add costs more than the parallelism
//   gives, so a short context is latency-bound by one block's pass over one
//   tile (the launch, the scores, the softmax, P·V).
//   Head dims D = DV 64, 128 and 256 (`launch`), 80 and 96 in a library of
//   their own (-DTPULLM_FLASH_NARROW, so that its nvcc runs beside this
//   one), and key width D ≠ value width DV at (192, 128) and (96, 64), the
//   decompressed MLA form of DeepSeek-V2 / PLM and of MiniCPM3, in a third
//   (-DTPULLM_FLASH_DKDV): the scores run over D, P·V, the partials and the
//   output over DV. At D = 256 an f32 cache's ring holds one stage (the
//   shared memory of two exceeds the SM's).
//   256 threads a block: in the scores, thread = (key, row group of 4), so
//   the 8B's R = 4 is one row a thread; q is held once as f32 in shared
//   memory. In P·V a row takes the power of two of threads at or above DV/4
//   (each 4 features): 32 at DV = 80, 96 and 128, 16 at DV = 64, whose lanes
//   past DV/4 (20, 24) idle, so that the row groups divide the 256 threads
//   and the 16 rows. K/V tiles go 16 bytes a thread into a 2-stage cp.async
//   ring; K rows are padded to an odd count of 16-byte units (the scores
//   read one key a lane), V rows are not (P·V reads along a row).
//   Scores, softmax and P·V are f32 FMAs (no new rounding point; int8
//   codes, f16 and bf16 are exact in f32, f32 is read as it is). A split
//   writes f32 (m, l, acc) partials; the last block of each (batch, KV
//   head) to finish, found through a counter of the launch's stream
//   (ops/kernels/_build.py counters) that it resets, merges them in split
//   order (deterministic), folds in the sink column, divides by safe l and rounds to bf16. The combine runs in the
//   same launch rather than as a second kernel because decode is host-bound
//   (the card idles most of a token): a second launch a layer would cost
//   the host as much as the kernel costs the card. A batch with one split
//   finishes without partials.
//
// Otherwise (prefill): flash_prefill_kernel, tensor cores, FlashAttention-2
//   layout. What bounds it: the QK and PV products, 2 · (D + DV) · (visible
//   pairs) · H FLOP against 989 TFLOP/s. A block of 4 warps holds 64 query rows of
//   one head, each warp 16 rows (at DV = 256, 8 warps: each row group's two
//   warps hold one half of O's features each, 64 f32 a thread as at
//   DV = 128, and both compute the group's scores); 64-key K/V tiles go
//   through a 2-stage cp.async ring and are read by ldmatrix; QK and PV are mma.sync
//   m16n8k16 with bf16 inputs and f32 sums (D / 16 k-steps of QK, DV / 8
//   n-tiles of O a warp); the online softmax stays in
//   registers. Tiles wholly above the block's causal diagonal or before its
//   window are never loaded; a warp skips the tiles wholly above its own
//   diagonal or before its own window, and masks only tiles that straddle
//   an edge. The other cache types reach the tensor cores through a
//   conversion pass per tile in shared memory from a ring of raw tiles. q8:
//   the int8 codes are exact in bf16; the per-key K scale multiplies the
//   f32 score after the product; the per-key V scale folds into p. f16 and
//   f32: each value as two bf16 terms, hi = bf16(x) and lo = bf16(x − hi),
//   exact for f16 (11 significant bits) and about 16 bits of f32's 24;
//   QK takes q·K_hi + q·K_lo and PV adds p_hi·V_lo to the two p terms below
//   (p_lo·V_lo, under 2^-16 of the product, is left out). At D = 256 the
//   f16 ring holds one stage and the f32 one none, at (192, 128) the f32
//   ring one (PreSmem). The new rounding
//   point, p (or p · v_s) to bf16 for the PV product, is carried as two bf16
//   terms, hi = bf16(p), lo = bf16(p − hi), so p is kept to about 16 bits
//   against f32's 24; the JAX kernel multiplies in f32.
//
// The latent form (the MLA cache: one bf16 KV head whose rows are
// [kv_lora latent | rope key] and whose values are each row's first kv_lora
// features, a view the JAX kernel takes as its own v; DeepSeek-V2/V3 and
// PLM at (DK, DV) = (576, 512), MiniCPM3 at (288, 256)) is flash_mla_kernel
// (below), both regimes on the tensor cores, with a regime rule of its own:
// the decode regime takes R ≤ kLatentDecodeRows = 64 query rows, in row
// groups of 16 (MiniCPM3's 40 heads at T = 1 are three, V2-Lite's verify at
// T = 2–4 two to four), because all of a latent's heads share its one KV
// head: the prefill grid would give R = 40 rows 40 blocks, each reading
// the whole latent for one of its 32 rows, with no split over the keys.
// It is its own library (-DTPULLM_FLASH_LATENT, the entry
// tpullm_flash_latent_bf16), so that its nvcc runs beside the dense and q8
// one.

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

using namespace tpullm;

constexpr float kNegInf = -1e30f;  // the running max before any key
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDecodeRows = 16;    // rows of a decode block (a row group)
constexpr int kDecodeMaxRows = 80;  // R = T·G at most this in the dense decode regime
constexpr int kLatentDecodeRows = 64;  // the latent form's decode regime: R at most this
constexpr int kDecThreads = 256;  // 64 keys × 4 row groups in the scores
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecTK = 64;         // keys a tile (decode)
constexpr int kMaxSplits = 64;     // splits of one (batch, KV head) at most
constexpr int kPreThreads = 128;   // 4 warps × 16 query rows (each half of Dv at D = 256)
constexpr int kPreBM = 64;         // query rows a prefill block
constexpr int kPreTK = 64;         // keys a tile (prefill)
constexpr int kMaxSmem = 232448;   // a block's shared memory at most (227 KB)

__device__ __forceinline__ float exp_e(float x) { return exp2f(x * kLog2e); }

// the cache element types (the template parameter KV) and their bytes
constexpr int kKvBf16 = 0, kKvF16 = 1, kKvF32 = 2, kKvQ8 = 3;
template <int KV>
__host__ __device__ constexpr int kv_bytes() {
  return KV == kKvQ8 ? 1 : KV == kKvF32 ? 4 : 2;
}

// The decode regime's split of one batch's keys: [lo, hi) in n splits of
// `per` keys (whole tiles), as ops/kernels/flash.py kv_splits.
struct KvSplit {
  int lo, hi, per, n;
};
__device__ __forceinline__ KvSplit kv_split(int off, int T, int S, int window, int max_splits) {
  KvSplit p;
  p.lo = window > 0 ? max(0, off - window + 1) : 0;
  p.hi = min(S, off + T);
  const int tiles = max(1, (p.hi - p.lo + kDecTK - 1) / kDecTK);
  const int splits = min(max_splits, tiles);
  const int per_tiles = (tiles + splits - 1) / splits;
  p.per = per_tiles * kDecTK;
  p.n = (tiles + per_tiles - 1) / per_tiles;
  return p;
}

// int8 code `byte` of w → f32 exactly: the code + 128 (its sign bit
// flipped) in the low mantissa bits of 2^23, less 2^23 + 128
__device__ __forceinline__ float code_f32(uint32_t w, int byte) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440u + byte)) - 8388736.f;
}

// four values of shared memory in the cache's type → f32 (exact)
template <int KV>
__device__ __forceinline__ void load4(const char* p, float (&v)[4]) {
  if constexpr (KV == kKvQ8) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = code_f32(w, c);
  } else if constexpr (KV == kKvF32) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (KV == kKvF16) {
    const __half2* h = reinterpret_cast<const __half2*>(p);
    const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
    load_bf16x4(reinterpret_cast<const __nv_bfloat16*>(p), v);
  }
}

// the 16 bytes of `raw` (16 / kv_bytes values in the cache's type) → f32
template <int KV>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[16 / kv_bytes<KV>()]) {
  const char* p = reinterpret_cast<const char*>(&raw);
#pragma unroll
  for (int e = 0; e < 16 / kv_bytes<KV>(); e += 4) {
    float f[4];
    load4<KV>(p + e * kv_bytes<KV>(), f);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[e + c] = f[c];
  }
}

// Finishes one decode row from its merged (m, l, acc) for features 4·dq ..
// of DV: the sink column in the normalizer only, safe l, bf16 to out[b, t, h].
__device__ __forceinline__ void decode_finish(__nv_bfloat16* __restrict__ out, int b, int T,
                                              int H, int h, int t, int DV, int dq, float m,
                                              float l, const float (&o)[4],
                                              const float* __restrict__ sinks) {
  float c = 1.f;
  if (sinks != nullptr) {
    const float sk = sinks[h];
    const float m_f = fmaxf(m, sk);
    c = exp_e(m - m_f);
    l = l * c + exp_e(sk - m_f);
  }
  const float inv = c / (l > 0.f ? l : 1.f);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0] * inv, o[1] * inv);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2] * inv, o[3] * inv);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + (((size_t)b * T + t) * H + h) * DV + 4 * dq) = w;
}

// Shared memory of a decode block: q rows (f32, D wide), the K/V ring (K
// rows of D padded to an odd count of 16-byte units, by 16 bytes or, where
// the row is an odd count already (q8 at D = 80: 5), by 32, so that 8 lanes
// reading 16 bytes of 8 keys hit distinct banks; V rows of DV unpadded: a
// row's lanes read along it; q8: the per-key scales after V), the
// probabilities p [16][65] and per-row state.
// The ring holds two stages where they fit, else one (f32 at D = 256: the
// next tile is then loaded after the P·V of this one).
template <int D, int DV, int KV>
struct DecSmem {
  static constexpr bool kQ8 = KV == kKvQ8;
  static constexpr int kEs = kv_bytes<KV>();
  static constexpr int kKPitch = D * kEs + (D * kEs / 16 % 2 ? 32 : 16);
  static constexpr int kVPitch = DV * kEs;
  static constexpr int kV = kDecTK * kKPitch;
  static constexpr int kScales = kV + kDecTK * kVPitch;
  static constexpr int kStage = kScales + (kQ8 ? 2 * kDecTK * 4 : 0);
  static constexpr int kPPitch = kDecTK + 1;
  static constexpr int q_off = 0;
  static constexpr int ring_off = kDecodeRows * D * 4;
  static constexpr int kTail = kDecodeRows * kPPitch * 4 + 4 * kDecodeRows * 4 + 16;
  static constexpr int kStages = ring_off + 2 * kStage + kTail <= kMaxSmem ? 2 : 1;
  static constexpr int p_off = ring_off + kStages * kStage;
  static constexpr int row_off = p_off + kDecodeRows * kPPitch * 4;
  static constexpr int bytes = row_off + 4 * kDecodeRows * 4 + 16;
  static_assert(kStages * kStage >= 2 * kMaxSplits * kDecodeRows * 4,
                "the ring holds every split's (m, l) for the combine");
  static_assert(D % 16 == 0 && DV % 16 == 0 && DV <= D, "K/V rows are whole 16-byte copies");
  static_assert(kKPitch / 16 % 2 == 1, "a K row spans an odd count of 16-byte units");
  static_assert(bytes <= kMaxSmem, "a block's shared memory fits the SM");
};

// the least power of two at or above n
__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

template <int D, int DV, int KV>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, T, H, D]
                    const char* __restrict__ k,            // [B, Hkv, S, D] of type KV
                    const char* __restrict__ v,            // [B, Hkv, S, DV] of type KV
                    const float* __restrict__ k_scale,     // [B, Hkv, S] (q8)
                    const float* __restrict__ v_scale,
                    const int* __restrict__ offsets,       // [B]
                    const float* __restrict__ sinks,       // [H] or null
                    const float* __restrict__ slopes,      // [H] or null
                    __nv_bfloat16* __restrict__ out,       // [B, T, H, DV]
                    float* __restrict__ partial,           // [B·Hkv, max_splits, R, DV + 2]
                    int* __restrict__ counters,            // [B·Hkv, ⌈R/16⌉], zero between launches
                    int T, int H, int Hkv, int S, float scale, float softcap, int window,
                    int max_splits) {
  using L = DecSmem<D, DV, KV>;
  constexpr bool kQ8 = L::kQ8;
  constexpr int RB = D * L::kEs;    // bytes of one K row
  constexpr int RBV = DV * L::kEs;  // bytes of one V row
  constexpr int QD = DV / 4;                // 4-feature groups of a row in P·V
  constexpr int QT = pow2_at_least(QD);     // threads a row in P·V (those past QD idle)
  constexpr int RG = kDecThreads / QT;      // row groups in P·V
  constexpr int RPT = kDecodeRows / RG;     // rows a thread in P·V
  static_assert(kDecThreads % QT == 0 && RG > 0 && kDecodeRows % RG == 0 && RPT * RG == kDecodeRows,
                "P·V's row groups divide the block's threads and its rows");
  static_assert(kDecThreads % kDecTK == 0 && kDecodeRows % (kDecThreads / kDecTK) == 0 &&
                    kDecodeRows % kDecWarps == 0,
                "the scores' row groups and the softmax's warps divide the rows");
  extern __shared__ __align__(16) char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  char* ring = smem + L::ring_off;
  float* ps = reinterpret_cast<float*>(smem + L::p_off);
  float* corr_s = reinterpret_cast<float*>(smem + L::row_off);
  float* m_s = corr_s + kDecodeRows;
  float* l_s = m_s + kDecodeRows;
  int* flag = reinterpret_cast<int*>(l_s + kDecodeRows);

  const int grp = blockIdx.x, b = grp / Hkv, hk = grp % Hkv, z = blockIdx.y;
  // this block's row group: rows r0 .. r0 + NR − 1 of the R; local row r is
  // global row r0 + r (query t = (r0 + r) / G of head hk·G + (r0 + r) % G)
  const int G = H / Hkv, R = T * G, r0 = kDecodeRows * blockIdx.z;
  const int NR = min(kDecodeRows, R - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = offsets[b];
  const KvSplit sp = kv_split(off, T, S, window, max_splits);
  if (z >= sp.n) return;
  const int k0 = sp.lo + z * sp.per, k1 = min(sp.hi, k0 + sp.per);
  const int ntiles = (k1 - k0 + kDecTK - 1) / kDecTK;  // ≥ 1 but for an empty range

  const size_t kv_row0 = ((size_t)b * Hkv + hk) * S;
  const char* kb = k + kv_row0 * RB;
  const char* vb = v + kv_row0 * RBV;
  auto load_tile = [&](int it) {
    char* st = ring + (it % L::kStages) * L::kStage;
    const int kt = k0 + it * kDecTK;
    // 16 bytes of a K row, and of the V row beside it while the V row
    // (DV ≤ D) lasts
    for (int i = tid; i < kDecTK * (RB / 16); i += kDecThreads) {
      const int r = i / (RB / 16), seg = (i % (RB / 16)) * 16;
      const bool ok = kt + r < k1;
      const size_t row = ok ? kt + r : kt;
      cp_async16(st + r * L::kKPitch + seg, kb + row * RB + seg, ok ? 16 : 0);
      if (seg < RBV)
        cp_async16(st + L::kV + r * L::kVPitch + seg, vb + row * RBV + seg, ok ? 16 : 0);
    }
    if constexpr (kQ8) {
      for (int i = tid; i < 2 * kDecTK; i += kDecThreads) {
        const int r = i % kDecTK;
        const bool ok = kt + r < k1;
        const float* src = (i < kDecTK ? k_scale : v_scale) + kv_row0 + (ok ? kt + r : kt);
        cp_async4(st + L::kScales + i * 4, src, ok ? 4 : 0);
      }
    }
  };

  if (ntiles > 0) load_tile(0);
  cp_async_commit();
  // q rows r0 + r = t·G + g (head hk·G + g, query t) as f32, once (the
  // scores read each of them for every key), rows past NR zero
  for (int i = tid; i < kDecodeRows * (D / 8); i += kDecThreads) {
    const int r = i / (D / 8), seg = (i % (D / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < NR) {
      const int rr = r0 + r;
      const __nv_bfloat16* qr = q + (((size_t)b * T + rr / G) * H + hk * G + rr % G) * D + seg;
      load_bf16x4(qr, f);
      load_bf16x4(qr + 4, f + 4);
    }
    *reinterpret_cast<float4*>(qs + r * D + seg) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(qs + r * D + seg + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }

  // scores: thread = key j of the tile, rows grp + kGroups·i; softmax: warp
  // w, rows w + kDecWarps·i; P·V: features 4·(tid % QT) .. (a thread whose
  // tid % QT ≥ QD holds none: `pv` false), rows tid / QT + RG·i
  constexpr int kGroups = kDecThreads / kDecTK;
  const int j = tid % kDecTK, grp_r = tid / kDecTK;
  const int dq = tid % QT, rg = tid / QT;
  const bool pv = dq < QD;
  float m_r[kDecodeRows / kDecWarps], l_r[kDecodeRows / kDecWarps];
#pragma unroll
  for (int i = 0; i < kDecodeRows / kDecWarps; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every reader of tile it-1 is done
    if (L::kStages > 1 && it + 1 < ntiles) load_tile(it + 1);
    cp_async_commit();
    const char* st = ring + (it % L::kStages) * L::kStage;
    const float* kss = reinterpret_cast<const float*>(st + L::kScales);
    const int kt = k0 + it * kDecTK;

    {  // scores of key j for rows grp_r, grp_r + kGroups, ...
      float s[kDecodeRows / kGroups];
#pragma unroll
      for (int i = 0; i < kDecodeRows / kGroups; ++i) s[i] = 0.f;
      const char* krow = st + j * L::kKPitch;
#pragma unroll 1  // unrolled, D = 64 spilled and the code grew
      for (int d0 = 0; d0 < D; d0 += 16 / L::kEs) {
        float kf[16 / L::kEs];
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + d0 * L::kEs);
        unpack16<KV>(raw, kf);
#pragma unroll
        for (int i = 0; i < kDecodeRows / kGroups; ++i) {
          const int r = grp_r + kGroups * i;
          if (r < NR) {
#pragma unroll
            for (int e0 = 0; e0 < 16 / L::kEs; e0 += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + d0 + e0);
              s[i] = fmaf(qv.x, kf[e0], s[i]);
              s[i] = fmaf(qv.y, kf[e0 + 1], s[i]);
              s[i] = fmaf(qv.z, kf[e0 + 2], s[i]);
              s[i] = fmaf(qv.w, kf[e0 + 3], s[i]);
            }
          }
        }
      }
      const int k_pos = kt + j;
      const float ksc = kQ8 ? kss[j] * scale : scale;
#pragma unroll
      for (int i = 0; i < kDecodeRows / kGroups; ++i) {
        const int r = grp_r + kGroups * i;
        if (r < NR) {
          const int q_pos = off + (r0 + r) / G;
          float x = s[i] * ksc;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          if (slopes != nullptr) x += slopes[hk * G + (r0 + r) % G] * (float)(k_pos - q_pos);
          bool ok = k_pos < k1 && k_pos <= q_pos;
          if (window > 0) ok = ok && k_pos > q_pos - window;
          ps[r * L::kPPitch + j] = ok ? x : -INFINITY;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kDecodeRows / kDecWarps; ++i) {  // online softmax, warp-uniform rows
      const int r = warp + kDecWarps * i;
      if (r < NR) {
        float* pr = ps + r * L::kPPitch;
        const float s0 = pr[lane], s1 = pr[lane + 32];
        const float m_new = fmaxf(m_r[i], warp_max(fmaxf(s0, s1)));
        float p0 = exp_e(s0 - m_new), p1 = exp_e(s1 - m_new);  // masked: exactly 0
        const float corr = exp_e(m_r[i] - m_new);
        l_r[i] = l_r[i] * corr + warp_sum(p0 + p1);
        m_r[i] = m_new;
        if constexpr (kQ8) {  // the V scale folds into p
          const float* vss = kss + kDecTK;
          p0 *= vss[lane];
          p1 *= vss[lane + 32];
        }
        pr[lane] = p0;
        pr[lane + 32] = p1;
        if (lane == 0) corr_s[r] = corr;
      }
    }
    __syncthreads();

    {  // acc = acc · corr + p · V
      const char* vt = st + L::kV + dq * 4 * L::kEs;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + RG * i;
        if (r < NR) {
          const float c = corr_s[r];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] *= c;
        }
      }
      const int nk = pv ? min(kDecTK, k1 - kt) : 0;  // keys past k1 have p = 0
#pragma unroll 4
      for (int jj = 0; jj < nk; ++jj) {
        float vv[4];
        load4<KV>(vt + jj * L::kVPitch, vv);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg + RG * i;
          if (r < NR) {
            const float p = ps[r * L::kPPitch + jj];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
          }
        }
      }
    }
    if constexpr (L::kStages == 1) {  // one stage: the next tile after every reader of this one
      __syncthreads();
      if (it + 1 < ntiles) load_tile(it + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kDecodeRows / kDecWarps; ++i) {
    const int r = warp + kDecWarps * i;
    if (r < NR && lane == 0) {
      m_s[r] = m_r[i];
      l_s[r] = l_r[i];
    }
  }
  __syncthreads();

  if (sp.n == 1) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + RG * i;
      if (pv && r < NR)
        decode_finish(out, b, T, H, hk * G + (r0 + r) % G, (r0 + r) / G, DV, dq, m_s[r], l_s[r],
                      acc[i], sinks);
    }
    return;
  }

  // partials of split z: acc [R][DV], then (m, l) [R][2] after all the acc;
  // this block's rows r0 .. r0 + NR − 1 of them
  const size_t n_acc = (size_t)gridDim.x * max_splits * R * DV;
  float* pacc = partial + (((size_t)grp * max_splits + z) * R + r0) * DV;
  float* pml = partial + n_acc + (((size_t)grp * max_splits + z) * R + r0) * 2;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    if (pv && r < NR)
      *reinterpret_cast<float4*>(pacc + (size_t)r * DV + 4 * dq) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (tid < NR) {
    pml[2 * tid] = m_s[tid];
    pml[2 * tid + 1] = l_s[tid];
  }
  int* counter = counters + (size_t)grp * gridDim.z + blockIdx.z;  // this row group's
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counter, 1) == sp.n - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();  // the last block: every split's partials are visible

  // every split's (m, l) into the ring (free now), then each row's merged
  // max, the weights exp(m_z − m) in place of m_z, and the merged l; split
  // zz's acc of local row r at gacc + (zz·R + r)·DV, its (m, l) at
  // gml + 2·(zz·R + r)
  const float* gacc = partial + ((size_t)grp * max_splits * R + r0) * DV;
  const float* gml = partial + n_acc + ((size_t)grp * max_splits * R + r0) * 2;
  float* cm = reinterpret_cast<float*>(ring);  // [n][NR]
  float* cl = cm + kMaxSplits * kDecodeRows;    // [n][NR]
  for (int i = tid; i < sp.n * NR; i += kDecThreads) {
    const size_t src = 2 * ((size_t)(i / NR) * R + i % NR);
    cm[i] = __ldcg(gml + src);
    cl[i] = __ldcg(gml + src + 1);
  }
  __syncthreads();
  if (tid < NR) {
    float m = kNegInf, l = 0.f;
    for (int zz = 0; zz < sp.n; ++zz) m = fmaxf(m, cm[zz * NR + tid]);
    for (int zz = 0; zz < sp.n; ++zz) {  // in split order
      const float w = exp_e(cm[zz * NR + tid] - m);
      cm[zz * NR + tid] = w;
      l += cl[zz * NR + tid] * w;
    }
    m_s[tid] = m;
    l_s[tid] = l;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    if (!pv || r >= NR) continue;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int zz = 0; zz < sp.n; ++zz) {  // in split order
      const float w = cm[zz * NR + r];
      const float4 a = __ldcg(reinterpret_cast<const float4*>(gacc + ((size_t)zz * R + r) * DV + 4 * dq));
      o[0] += a.x * w;
      o[1] += a.y * w;
      o[2] += a.z * w;
      o[3] += a.w * w;
    }
    decode_finish(out, b, T, H, hk * G + (r0 + r) % G, (r0 + r) / G, DV, dq, m_s[r], l_s[r], o,
                  sinks);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

// Shared memory of a prefill block: the K/V ring, rows (K and Q: D, V: DV)
// padded by 8 bf16 so that the 8 rows an ldmatrix reads fall in distinct
// bank groups. Other
// cache types than bf16: the ring holds the raw tiles (q8: and the per-key
// scales), and bf16 K and V tiles take each tile's conversion, kTerms of
// each (hi, then lo). The Q tile, read once into registers, is first copied
// into the space the second tile takes after it (ring stage 1; converted:
// the conversion tiles). The converted ring holds two stages where they fit
// the SM; f16 at D = 256 and f32 at (192, 128) hold one (the next tile is
// loaded once this one is converted), f32 at D = 256 none (each tile is
// converted straight from global memory).
template <int D, int DV, int KV>
struct PreSmem {
  static constexpr bool kQ8 = KV == kKvQ8;
  static constexpr bool kConv = KV != kKvBf16;
  static constexpr int kTerms = KV == kKvF16 || KV == kKvF32 ? 2 : 1;
  // warps a row group: above DV = 128 each of a row group's two warps holds
  // half of O's features (16 × 128 f32 a warp, as at DV = 128)
  static constexpr int kDvSplit = DV > 128 ? 2 : 1;
  static constexpr int kThreads = kPreThreads * kDvSplit;
  static constexpr int kPitch = D + 8;    // bf16 a row of Q and K
  static constexpr int kVPitch = DV + 8;  // bf16 a row of V
  static constexpr int kTile = kPreTK * kPitch * 2;    // a bf16 K tile (and the Q tile)
  static constexpr int kVTile = kPreTK * kVPitch * 2;  // a bf16 V tile
  static constexpr int kRaw = kPreTK * D * kv_bytes<KV>();    // bytes of one raw K tile
  static constexpr int kRawV = kPreTK * DV * kv_bytes<KV>();  // and of one raw V tile
  static constexpr int kStage = kConv ? kRaw + kRawV + (kQ8 ? 2 * kPreTK * 4 : 0) : kTile + kVTile;
  static constexpr int kConvBytes = kConv ? kTerms * (kTile + kVTile) : 0;
  static constexpr int kStages = 2 * kStage + kConvBytes <= kMaxSmem ? 2
                                 : kStage + kConvBytes <= kMaxSmem ? 1 : 0;
  static constexpr int ring_off = 0;
  static constexpr int conv_off = kStages * kStage;
  static constexpr int q_off = kConv ? conv_off : kStage;
  static constexpr int bytes = conv_off + kConvBytes;
  static_assert(kConv ? (!kQ8 || kStages == 2) : kStages == 2,
                "bf16 and q8 (whose scales stay in the ring) hold two stages");
  static_assert(D % 16 == 0 && DV % (16 * kDvSplit) == 0 && kPitch * 2 / 16 % 2 == 1 &&
                    kVPitch * 2 / 16 % 2 == 1,
                "whole 16-wide k-steps; a row spans an odd count of 16-byte units (ldmatrix's "
                "8 rows in distinct bank groups)");
  static_assert(kPreBM * kPitch * 2 <= bytes - q_off, "the Q tile fits where it is copied");
  static_assert(bytes <= kMaxSmem, "a block's shared memory fits the SM");
};

template <int D, int DV, int KV>
__global__ void __launch_bounds__(kPreThreads * (DV > 128 ? 2 : 1))
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const char* __restrict__ k,
                     const char* __restrict__ v, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ offsets,
                     const float* __restrict__ sinks, const float* __restrict__ slopes,
                     __nv_bfloat16* __restrict__ out, int T, int H, int Hkv, int S,
                     float scale, float softcap, int window) {
  using L = PreSmem<D, DV, KV>;
  constexpr bool kQ8 = L::kQ8;
  constexpr int P = L::kPitch;
  constexpr int PV = L::kVPitch;
  constexpr int NT = L::kThreads;
  constexpr int DW = DV / L::kDvSplit;      // O's features a warp
  constexpr int RB = D * kv_bytes<KV>();    // bytes of a K row in the cache
  constexpr int RBV = DV * kv_bytes<KV>();  // and of a V row
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  char* ring = smem + L::ring_off;

  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this warp's row group (16 query rows) and its half of O's features
  const int rw = warp % (kPreBM / 16), dh = warp / (kPreBM / 16);
  const int t0 = blockIdx.x * kPreBM;
  const int off = offsets[b];
  const int nrows = min(kPreBM, T - t0);
  const int q_first = off + t0, q_last = off + t0 + nrows - 1;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int k_end = min(S, q_last + 1);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kPreTK - 1) / kPreTK : 0;

  const size_t kv_row0 = ((size_t)b * Hkv + hk) * S;
  const char* kb = k + kv_row0 * RB;
  const char* vb = v + kv_row0 * RBV;
  auto load_tile = [&](int it) {
    if constexpr (L::kStages > 0) {
      char* st = ring + (it % L::kStages) * L::kStage;
      const int kt = k_begin + it * kPreTK;
      char* sv = st + (L::kConv ? L::kRaw : L::kTile);
      // 16 bytes of a K row, and of the V row beside it while it (DV ≤ D) lasts
      for (int i = tid; i < kPreTK * (RB / 16); i += NT) {
        const int r = i / (RB / 16), seg = (i % (RB / 16)) * 16;
        const bool ok = kt + r < k_end;
        const size_t row = ok ? kt + r : kt;
        cp_async16(st + r * (L::kConv ? RB : P * 2) + seg, kb + row * RB + seg, ok ? 16 : 0);
        if (seg < RBV)
          cp_async16(sv + r * (L::kConv ? RBV : PV * 2) + seg, vb + row * RBV + seg, ok ? 16 : 0);
      }
      if constexpr (kQ8) {
        for (int i = tid; i < 2 * kPreTK; i += NT) {
          const int r = i % kPreTK;
          const bool ok = kt + r < k_end;
          const float* src = (i < kPreTK ? k_scale : v_scale) + kv_row0 + (ok ? kt + r : kt);
          cp_async4(st + L::kRaw + L::kRawV + i * 4, src, ok ? 4 : 0);
        }
      }
    }
  };

  // the Q tile (rows past T zero) and the first K/V tile
  for (int i = tid; i < kPreBM * (D / 8); i += NT) {
    const int r = i / (D / 8), seg = (i % (D / 8)) * 8;
    const int t = t0 + min(r, nrows - 1);
    cp_async16(qs + r * P + seg, q + (((size_t)b * T + t) * H + h) * D + seg, r < nrows ? 16 : 0);
  }
  if (ntiles > 0) load_tile(0);
  cp_async_commit();

  // this warp's rows: 16·rw .. of the block; this thread's two rows
  const int w_rows = min(16, nrows - 16 * rw);
  const int w_first = q_first + 16 * rw, w_last = w_first + w_rows - 1;
  const int qa = w_first + (lane >> 2), qb = qa + 8;
  // the softmax runs in log2 units (scores times log2 e), so that each p is
  // one exp2: the scale, the softcap and the ALiBi slope carry the factor
  const float scale2 = scale * kLog2e, cap2 = softcap * kLog2e;
  const float inv_cap2 = softcap > 0.f ? 1.f / cap2 : 0.f;
  const float slope2 = slopes != nullptr ? slopes[h] * kLog2e : 0.f;

  uint32_t qf[D / 16][4];
  float o[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it (and Q) landed; every reader of tile it-1 is done
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], qs + (16 * rw + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
      __syncthreads();  // every warp holds its Q rows: their space takes tile 1
    }
    if (L::kStages == 2 && it + 1 < ntiles) load_tile(it + 1);
    cp_async_commit();
    const char* st = ring + (L::kStages > 0 ? (it % L::kStages) * L::kStage : 0);
    const int kt = k_begin + it * kPreTK;
    // the bf16 tiles the products read: K hi, K lo, V hi, V lo (the lo
    // tiles only with two terms)
    const __nv_bfloat16* kt_s;
    const __nv_bfloat16* vt_s;
    if constexpr (L::kConv) {  // raw tiles → kTerms bf16 terms each
      constexpr int kEs = kv_bytes<KV>();
      __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(smem + L::conv_off);
      // 16 values of row r of the K tile (or, `vt`, of the V tile) at seg:
      // the raw tile in the ring, or with no ring the cache's row (zero past
      // k_end), into kTerms bf16 terms
      auto convert = [&](bool vt, int r, int seg, bool ok) {
        const int W = vt ? DV : D;  // the row's values
        const char* src = L::kStages > 0
                              ? st + (vt ? L::kRaw : 0) + (r * W + seg) * kEs
                              : (vt ? vb : kb) + ((size_t)(ok ? kt + r : kt) * W + seg) * kEs;
        float f[16];
#pragma unroll
        for (int c = 0; c < kEs; ++c) {  // 16 values: kEs chunks of 16 bytes
          float g[16 / kEs];
          const uint4 raw = !ok ? make_uint4(0u, 0u, 0u, 0u)
                            : L::kStages > 0 ? *reinterpret_cast<const uint4*>(src + 16 * c)
                                             : __ldg(reinterpret_cast<const uint4*>(src + 16 * c));
          unpack16<KV>(raw, g);
#pragma unroll
          for (int e = 0; e < 16 / kEs; ++e) f[c * (16 / kEs) + e] = g[e];
        }
#pragma unroll
        for (int term = 0; term < L::kTerms; ++term) {
          __nv_bfloat16* dst =
              vt ? conv + L::kTerms * (L::kTile / 2) + term * (L::kVTile / 2) + r * PV + seg
                 : conv + term * (L::kTile / 2) + r * P + seg;
          uint32_t w[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const __nv_bfloat162 pr = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
            w[e] = *reinterpret_cast<const uint32_t*>(&pr);
            if (term + 1 < L::kTerms) {  // what the hi term leaves, for the lo term
              f[2 * e] -= __low2float(pr);
              f[2 * e + 1] -= __high2float(pr);
            }
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
        }
      };
      // a piece of K, and of the V row beside it while it (DV ≤ D) lasts
      for (int i = tid; i < kPreTK * (D / 16); i += NT) {
        const int r = i / (D / 16), seg = (i % (D / 16)) * 16;
        const bool ok = L::kStages > 0 || kt + r < k_end;
        convert(false, r, seg, ok);
        if (seg < DV) convert(true, r, seg, ok);
      }
      __syncthreads();
      if (L::kStages == 1) {  // the stage is free once converted: the next tile overlaps the products
        if (it + 1 < ntiles) load_tile(it + 1);
        cp_async_commit();
      }
      kt_s = conv;
      vt_s = conv + L::kTerms * (L::kTile / 2);
    } else {
      kt_s = reinterpret_cast<const __nv_bfloat16*>(st);
      vt_s = reinterpret_cast<const __nv_bfloat16*>(st + L::kTile);
    }
    // a warp skips a tile wholly above its diagonal or before its window
    if (w_rows <= 0 || kt > w_last || (window > 0 && kt + kPreTK - 1 <= w_first - window))
      continue;
    const bool edge = kt + kPreTK - 1 > w_first || kt + kPreTK > k_end ||
                      (window > 0 && kt <= w_last - window);

    float s[kPreTK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kPreTK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kPreTK / 16; ++np) {
        const int at = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int term = 0; term < L::kTerms; ++term) {
          uint32_t r[4];
          ldmatrix_x4(r, kt_s + term * (L::kTile / 2) + at);
          mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
        }
      }
    }

    const float* kss = reinterpret_cast<const float*>(st + L::kRaw + L::kRawV);  // q8 only
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < kPreTK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = nt * 8 + 2 * (lane & 3) + (e & 1);  // key within the tile
        const int k_pos = kt + kj, q_pos = e < 2 ? qa : qb;
        float x = s[nt][e] * (kQ8 ? kss[kj] * scale2 : scale2);
        if (softcap > 0.f) x = tanhf(x * inv_cap2) * cap2;
        if (slopes != nullptr) x += slope2 * (float)(k_pos - q_pos);
        if (edge) {
          bool ok = k_pos <= q_pos && k_pos < k_end;
          if (window > 0) ok = ok && k_pos > q_pos - window;
          x = ok ? x : -INFINITY;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_i[i] - mx[i]);
      m_i[i] = mx[i];
    }
    const float* vss = kss + kPreTK;
#pragma unroll
    for (int nt = 0; nt < kPreTK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - mx[e >> 1]);  // masked: exactly 0
        sum[e >> 1] += p;
        if constexpr (kQ8) p *= vss[nt * 8 + 2 * (lane & 3) + (e & 1)];
        s[nt][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * corr[i] + sum[i];
#pragma unroll
    for (int dt = 0; dt < DW / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

#pragma unroll
    for (int ks = 0; ks < kPreTK / 16; ++ks) {
      // p as hi + lo bf16 terms, in the A layout of the 16-key step
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float* src = &s[2 * ks + (f >> 1)][2 * (f & 1)];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(src[0], src[1]);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(src[0] - __low2float(hi),
                                                        src[1] - __high2float(hi));
        a_hi[f] = *reinterpret_cast<const uint32_t*>(&hi);
        a_lo[f] = *reinterpret_cast<const uint32_t*>(&lo);
      }
#pragma unroll
      for (int dp = 0; dp < DW / 16; ++dp) {
        const int at = (ks * 16 + (lane & 15)) * PV + dh * DW + dp * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt_s + at);
        mma_bf16(o[2 * dp], a_hi, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], a_hi, r[2], r[3]);
        mma_bf16(o[2 * dp], a_lo, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], a_lo, r[2], r[3]);
        if constexpr (L::kTerms == 2) {  // p_hi · V_lo
          ldmatrix_x4_trans(r, vt_s + L::kVTile / 2 + at);
          mma_bf16(o[2 * dp], a_hi, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], a_hi, r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (w_rows <= 0) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i], c = 1.f;
    if (sinks != nullptr) {  // the sink column joins the normalizer only
      const float sk = sinks[h] * kLog2e;
      const float m_f = fmaxf(m_i[i], sk);
      c = exp2f(m_i[i] - m_f);
      l = l * c + exp2f(sk - m_f);
    }
    inv[i] = c / (l > 0.f ? l : 1.f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 16 * rw + (lane >> 2) + 8 * i;
    if (t >= T) continue;
    __nv_bfloat16* dst = out + (((size_t)b * T + t) * H + h) * DV + dh * DW + 2 * (lane & 3);
#pragma unroll
    for (int dt = 0; dt < DW / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(o[dt][2 * i] * inv[i], o[dt][2 * i + 1] * inv[i]);
  }
}

// The latent form (the MLA cache: DK = 576, DV = 512 or DK = 288, DV = 256,
// bf16, one KV head whose rows hold the keys and, in their first DV
// features, the values), both regimes on the tensor cores: mma.sync
// m16n8k16 as flash_prefill_kernel, but Q (36 or 18 16-wide k-steps) does
// not fit in registers beside O, so it stays in shared memory and is read
// by ldmatrix at every tile, and O (16 × DV f32 a row group of 16 query
// rows) is split over the row group's four warps, DV / 4 features each. The scores are not
// computed four times: each warp takes a quarter of the tile's 64 keys over
// the whole DK, the four exchange their partial row maxima through shared
// memory (so the online softmax's max is the tile's), and each writes its p
// as hi + lo bf16 terms (as flash_prefill_kernel rounds it) into a shared
// [16][64] tile that all four read as the A operand of P·V. A row group's
// warps meet at a named barrier of their own, so a row group that skips a
// tile (wholly above its diagonal) waits for no other. Each K tile is
// loaded once (a 2-stage cp.async ring of 64-key tiles) and serves QK (all
// DK features) and P·V (its first DV features, ldmatrix .trans). No
// softcap, ALiBi, window or sinks (MLA has none; the wrapper refuses them).
//   kSplit = false (prefill, T·H/Hkv > 64): a block is 32 query rows of one
//   head (two row groups, 256 threads), keys from 0 to its last row's
//   position; 196,624 bytes of shared memory at (576, 512). Bound: the QK
//   and PV products, 2 · (DK + DV) · (visible pairs) · H FLOP against 989
//   TFLOP/s.
//   kSplit = true (decode, T·H/Hkv ≤ kLatentDecodeRows = 64: DeepSeek's 16
//   heads at T = 1 are exactly one row group, MiniCPM3's 40 three): a block
//   is one row group, rows r = 16·y .. 16·y + 15 (y = blockIdx.z) of the R
//   rows r = t·G + g of one (batch, KV head), over one split of its keys
//   (kv_split, as flash_decode_kernel cuts them), 128 threads; a split
//   writes f32 (m, l, acc) partials of its rows and the last of the splits
//   of its (batch, KV head, row group), found through that group's own
//   counter, merges them in split order, as flash_decode_kernel does. A
//   row's order is the same whatever the row groups: each row group reads
//   the same tiles (from L2 after the first), and no row waits for
//   another's group. 173,072 bytes of shared memory at (576, 512). Bound:
//   the latent rows up to kv_len, read once. The scores are on the tensor
//   cores here too: on CUDA cores, as flash_decode_kernel forms them, each
//   key re-reads the 16 query rows of 576 from shared memory (0.030 ms for
//   one 64-key tile, measured on the card).
constexpr int kMlaWarpsRG = 4;  // warps a row group of 16 rows

template <bool kSplit>
__host__ __device__ constexpr int mla_rows() {  // query rows a block
  return kSplit ? 16 : 32;
}
template <bool kSplit>
__host__ __device__ constexpr int mla_threads() {
  return mla_rows<kSplit>() / 16 * kMlaWarpsRG * 32;
}

template <int DK, int DV, bool kSplit>
struct MlaSmem {
  static constexpr int kBM = mla_rows<kSplit>();
  static constexpr int kPitch = DK + 8;         // bf16 a row of Q and of a K tile
  static constexpr int kTile = kPreTK * kPitch * 2;
  static constexpr int kPPitch = kPreTK + 8;    // bf16 a row of p
  static constexpr int q_off = 0;
  static constexpr int ring_off = kBM * kPitch * 2;
  static constexpr int p_off = ring_off + 2 * kTile;             // p hi, then p lo: [BM][kPPitch]
  static constexpr int mx_off = p_off + 2 * kBM * kPPitch * 2;   // [BM][kMlaWarpsRG] f32
  static constexpr int bytes = mx_off + kBM * kMlaWarpsRG * 4 + 16;
  static_assert(DK % 16 == 0 && DV % (16 * kMlaWarpsRG) == 0 && DV < DK, "the latent dims");
  static_assert(2 * kTile >= 2 * kMaxSplits * kDecodeRows * 4,
                "the ring holds every split's (m, l) for the combine");
  static_assert(bytes <= kMaxSmem, "a block's shared memory fits the SM");
};

// the named barrier of one row group's kMlaWarpsRG warps (id 0 is __syncthreads)
__device__ __forceinline__ void row_group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kMlaWarpsRG * 32) : "memory");
}

template <int DK, int DV, bool kSplit>
__global__ void __launch_bounds__(mla_threads<kSplit>())
flash_mla_kernel(const __nv_bfloat16* __restrict__ q,   // [B, T, H, DK]
                 const __nv_bfloat16* __restrict__ kv,  // [B, Hkv, S, DK]; V = [..., :DV]
                 const int* __restrict__ offsets,       // [B]
                 __nv_bfloat16* __restrict__ out,       // [B, T, H, DV]
                 float* __restrict__ partial,           // [B·Hkv, max_splits, R, DV + 2] (split)
                 int* __restrict__ counters,            // [B·Hkv·row groups], zero after a launch
                 int T, int H, int Hkv, int S, float scale, int max_splits) {
  using L = MlaSmem<DK, DV, kSplit>;
  constexpr int BM = L::kBM;
  constexpr int NT = mla_threads<kSplit>();
  constexpr int P = L::kPitch;
  constexpr int PP = L::kPPitch;
  constexpr int QW = kPreTK / kMlaWarpsRG;  // keys a warp scores in a tile
  constexpr int DW = DV / kMlaWarpsRG;      // O's features a warp holds
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  char* ring = smem + L::ring_off;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp / kMlaWarpsRG, wq = warp % kMlaWarpsRG;  // row group, quarter
  const int G = H / Hkv;
  // prefill: 32 rows t0 .. of head h; split: rows r0 .. r0 + nrows − 1 of
  // the R = T·G rows r = t·G + g of KV head hk, split z of its keys [k0, k1)
  int b, hk, h = 0, t0 = 0, r0 = 0, nrows, k0 = 0, k1, n_split = 1, grp = 0, z = 0;
  if constexpr (kSplit) {
    grp = blockIdx.x;
    b = grp / Hkv;
    hk = grp % Hkv;
    z = blockIdx.y;
    r0 = 16 * blockIdx.z;
    nrows = min(16, T * G - r0);
    const KvSplit sp = kv_split(offsets[b], T, S, 0, max_splits);
    if (z >= sp.n) return;
    n_split = sp.n;
    k0 = sp.lo + z * sp.per;
    k1 = min(sp.hi, k0 + sp.per);
  } else {
    b = blockIdx.y / H;
    h = blockIdx.y % H;
    hk = h / G;
    t0 = blockIdx.x * BM;
    nrows = min(BM, T - t0);
    k1 = min(S, offsets[b] + t0 + nrows);  // up to the block's last row
  }
  const int off = offsets[b];
  const int ntiles = k1 > k0 ? (k1 - k0 + kPreTK - 1) / kPreTK : 0;
  const __nv_bfloat16* kb = kv + ((size_t)b * Hkv + hk) * S * DK;
  auto load_tile = [&](int it) {
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(ring + (it & 1) * L::kTile);
    const int kt = k0 + it * kPreTK;
    for (int i = tid; i < kPreTK * (DK / 8); i += NT) {
      const int r = i / (DK / 8), seg = (i % (DK / 8)) * 8;
      const bool ok = kt + r < k1;
      cp_async16(st + r * P + seg, kb + (size_t)(ok ? kt + r : kt) * DK + seg, ok ? 16 : 0);
    }
  };
  // the query row of block row r (rows past nrows zero)
  auto q_row = [&](int r) -> const __nv_bfloat16* {
    if constexpr (kSplit)
      return q + (((size_t)b * T + (r0 + r) / G) * H + hk * G + (r0 + r) % G) * DK;
    return q + (((size_t)b * T + t0 + r) * H + h) * DK;
  };
  for (int i = tid; i < BM * (DK / 8); i += NT) {
    const int r = i / (DK / 8), seg = (i % (DK / 8)) * 8;
    cp_async16(qs + r * P + seg, q_row(min(r, nrows - 1)) + seg, r < nrows ? 16 : 0);
  }
  if (ntiles > 0) load_tile(0);
  cp_async_commit();

  // this row group's rows and this thread's two of them (a row past nrows
  // sees no key); its p tiles and maxima
  const int w_rows = min(16, nrows - 16 * rw);
  const int ra = 16 * rw + (lane >> 2), rb = ra + 8;
  auto q_pos = [&](int r) {
    if (r >= nrows) return -1;
    return kSplit ? off + (r0 + r) / G : off + t0 + r;
  };
  const int qa = q_pos(ra), qb = q_pos(rb);
  const int w_first = kSplit ? off : off + t0 + 16 * rw;  // the row group's first position
  const int w_last = kSplit ? off + T - 1 : w_first + w_rows - 1;
  __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off) + 16 * rw * PP;
  __nv_bfloat16* p_lo = p_hi + BM * PP;
  float* mx_s = reinterpret_cast<float*>(smem + L::mx_off) + 16 * rw * kMlaWarpsRG;
  const float scale2 = scale * kLog2e;  // the softmax in log2 units, as flash_prefill_kernel

  float o[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it (and Q) landed; every reader of tile it-1 and of p is done
    if (it + 1 < ntiles) load_tile(it + 1);
    cp_async_commit();
    const int kt = k0 + it * kPreTK;
    if (w_rows <= 0 || kt > w_last) continue;  // the row group sees no key of the tile
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(ring + (it & 1) * L::kTile);
    const bool edge = kSplit || kt + kPreTK - 1 > w_first || kt + kPreTK > k1;

    // this warp's QW keys (wq·QW ..) against the row group's 16 rows, over all of DK
    float s[QW / 8][4];
#pragma unroll
    for (int nt = 0; nt < QW / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + (16 * rw + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < QW / 16; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (wq * QW + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, r[0], r[1]);
        mma_bf16(s[2 * np + 1], a, r[2], r[3]);
      }
    }
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < QW / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k_pos = kt + wq * QW + nt * 8 + 2 * (lane & 3) + (e & 1);
        float x = s[nt][e] * scale2;
        if (edge && !(k_pos <= (e < 2 ? qa : qb) && k_pos < k1)) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if ((lane & 3) == 0) {  // the tile's row maxima: the four warps' partial ones
      mx_s[(lane >> 2) * kMlaWarpsRG + wq] = mx[0];
      mx_s[((lane >> 2) + 8) * kMlaWarpsRG + wq] = mx[1];
    }
    row_group_sync(1 + rw);
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* row = mx_s + ((lane >> 2) + 8 * i) * kMlaWarpsRG;
#pragma unroll
      for (int w = 0; w < kMlaWarpsRG; ++w) mx[i] = fmaxf(mx[i], row[w]);
      corr[i] = exp2f(m_i[i] - mx[i]);
      m_i[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < QW / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // p as hi + lo bf16 terms into the row group's p tiles
        const float p0 = exp2f(s[nt][2 * i] - mx[i]), p1 = exp2f(s[nt][2 * i + 1] - mx[i]);
        sum[i] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - __low2float(hi), p1 - __high2float(hi));
        const int at = ((lane >> 2) + 8 * i) * PP + wq * QW + nt * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(p_hi + at) = hi;
        *reinterpret_cast<__nv_bfloat162*>(p_lo + at) = lo;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * corr[i] + sum[i];  // over this warp's keys
#pragma unroll
    for (int dt = 0; dt < DW / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
    row_group_sync(1 + rw);

    // P·V over the tile's 64 keys for this warp's DW features
#pragma unroll
    for (int kq = 0; kq < kPreTK / 16; ++kq) {
      uint32_t a_hi[4], a_lo[4];
      ldmatrix_x4(a_hi, p_hi + (lane & 15) * PP + kq * 16 + (lane >> 4) * 8);
      ldmatrix_x4(a_lo, p_lo + (lane & 15) * PP + kq * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < DW / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ks + (kq * 16 + (lane & 15)) * P + wq * DW + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a_hi, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], a_hi, r[2], r[3]);
        mma_bf16(o[2 * dp], a_lo, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], a_lo, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

  // l: each warp's sums over its keys, summed over the row group's four warps
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
  }
  __syncthreads();  // every warp is past its last tile: the maxima's space is free
  if ((lane & 3) == 0) {
    mx_s[(lane >> 2) * kMlaWarpsRG + wq] = l_i[0];
    mx_s[((lane >> 2) + 8) * kMlaWarpsRG + wq] = l_i[1];
  }
  __syncthreads();
  float l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* row = mx_s + ((lane >> 2) + 8 * i) * kMlaWarpsRG;
    l_row[i] = 0.f;
#pragma unroll
    for (int w = 0; w < kMlaWarpsRG; ++w) l_row[i] += row[w];
  }
  // output row r of this block: [b, t, head]
  auto out_row = [&](int r) -> __nv_bfloat16* {
    if constexpr (kSplit)
      return out + (((size_t)b * T + (r0 + r) / G) * H + hk * G + (r0 + r) % G) * DV;
    return out + (((size_t)b * T + t0 + r) * H + h) * DV;
  };
  if (n_split == 1) {
    if (w_rows <= 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ra + 8 * i;
      if (r >= nrows) continue;
      const float inv = 1.f / (l_row[i] > 0.f ? l_row[i] : 1.f);
      __nv_bfloat16* dst = out_row(r) + wq * DW + 2 * (lane & 3);
#pragma unroll
      for (int dt = 0; dt < DW / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    }
    return;
  }
  if constexpr (kSplit) {
    // partials of split z: acc [R][DV], then (m, l) [R][2] after all the
    // acc; this block's rows r0 .. r0 + nrows − 1 of them
    const int R = T * G;
    const size_t n_acc = (size_t)gridDim.x * max_splits * R * DV;
    float* pacc = partial + (((size_t)grp * max_splits + z) * R + r0) * DV;
    float* pml = partial + n_acc + (((size_t)grp * max_splits + z) * R + r0) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ra + 8 * i;
      if (r >= nrows) continue;
#pragma unroll
      for (int dt = 0; dt < DW / 8; ++dt)
        *reinterpret_cast<float2*>(pacc + (size_t)r * DV + wq * DW + dt * 8 + 2 * (lane & 3)) =
            make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
      if (wq == 0 && (lane & 3) == 0) {
        pml[2 * r] = m_i[i];
        pml[2 * r + 1] = l_row[i];
      }
    }
    int* flag = reinterpret_cast<int*>(smem + L::mx_off + BM * kMlaWarpsRG * 4);
    int* counter = counters + (size_t)grp * gridDim.z + blockIdx.z;  // this row group's
    __threadfence();  // this block's partials are visible before its count
    __syncthreads();
    if (tid == 0) *flag = atomicAdd(counter, 1) == n_split - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();  // the last block: every split's partials are visible

    // every split's (m, l) into the ring (free now), each row's merged max,
    // the weights 2^(m_z − m) in place of m_z (m is in log2 units here), the
    // merged l
    // this row group's rows, global row r0 + r: their acc at gacc + (zz·R +
    // r)·DV and (m, l) at gml + 2·(zz·R + r) for split zz
    const float* gacc = partial + ((size_t)grp * max_splits * R + r0) * DV;
    const float* gml = partial + n_acc + ((size_t)grp * max_splits * R + r0) * 2;
    const int NR = nrows;
    float* cm = reinterpret_cast<float*>(ring);  // [n][NR]
    float* cl = cm + kMaxSplits * kDecodeRows;   // [n][NR]
    float* m_s = mx_s;                           // [NR] (row group 0's maxima space)
    float* l_s = m_s + kDecodeRows;
    for (int i = tid; i < n_split * NR; i += NT) {
      const int zz = i / NR, r = i % NR;
      cm[i] = __ldcg(gml + 2 * ((size_t)zz * R + r));
      cl[i] = __ldcg(gml + 2 * ((size_t)zz * R + r) + 1);
    }
    __syncthreads();
    if (tid < NR) {
      float m = kNegInf, l = 0.f;
      for (int zz = 0; zz < n_split; ++zz) m = fmaxf(m, cm[zz * NR + tid]);
      for (int zz = 0; zz < n_split; ++zz) {  // in split order
        const float w = exp2f(cm[zz * NR + tid] - m);
        cm[zz * NR + tid] = w;
        l += cl[zz * NR + tid] * w;
      }
      m_s[tid] = m;
      l_s[tid] = l;
    }
    __syncthreads();
    for (int i = tid; i < NR * (DV / 4); i += NT) {
      const int r = i / (DV / 4), dq = i % (DV / 4);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int zz = 0; zz < n_split; ++zz) {  // in split order
        const float w = cm[zz * NR + r];
        const float4 a =
            __ldcg(reinterpret_cast<const float4*>(gacc + ((size_t)zz * R + r) * DV + 4 * dq));
        acc[0] += a.x * w;
        acc[1] += a.y * w;
        acc[2] += a.z * w;
        acc[3] += a.w * w;
      }
      decode_finish(out, b, T, H, hk * G + (r0 + r) % G, (r0 + r) / G, DV, dq, m_s[r], l_s[r], acc,
                    nullptr);
    }
    if (tid == 0) *counter = 0;  // ready for the next launch
  }
}

// A kernel's dynamic shared memory (above 48 KB) and the whole SM's shared
// memory preferred over L1, so that the blocks it allows fit on one SM.
template <class Kernel>
cudaError_t smem_attributes(Kernel* kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int D, int DV, int KV>
int launch_d(const void* q, const void* k, const void* k_scale, const void* v,
             const void* v_scale, const void* offsets, const void* sinks, const void* slopes,
             void* out, void* partial, void* counters, int B, int T, int H, int Hkv, int S,
             float scale, float softcap, int window, int max_splits, cudaStream_t stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const char*>(k);
  const auto* vb = static_cast<const char*>(v);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* ob = static_cast<const int*>(offsets);
  const auto* sk = static_cast<const float*>(sinks);
  const auto* sl = static_cast<const float*>(slopes);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (max_splits > 0) {  // the decode regime, a block a row group of kDecodeRows
    const int R = T * (H / Hkv);
    if (max_splits > kMaxSplits || R > kDecodeMaxRows) return (int)cudaErrorInvalidValue;
    constexpr int smem = DecSmem<D, DV, KV>::bytes;
    static const cudaError_t attr = smem_attributes(flash_decode_kernel<D, DV, KV>, smem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid(B * Hkv, max_splits, (R + kDecodeRows - 1) / kDecodeRows);
    flash_decode_kernel<D, DV, KV><<<grid, kDecThreads, smem, stream>>>(
        qb, kb, vb, ks, vs, ob, sk, sl, o, static_cast<float*>(partial),
        static_cast<int*>(counters), T, H, Hkv, S, scale, softcap, window, max_splits);
  } else {
    if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
    constexpr int smem = PreSmem<D, DV, KV>::bytes;
    static const cudaError_t attr = smem_attributes(flash_prefill_kernel<D, DV, KV>, smem);
    if (attr != cudaSuccess) return (int)attr;
    flash_prefill_kernel<D, DV, KV><<<dim3((T + kPreBM - 1) / kPreBM, B * H),
                                       PreSmem<D, DV, KV>::kThreads, smem, stream>>>(
        qb, kb, vb, ks, vs, ob, sk, sl, o, T, H, Hkv, S, scale, softcap, window);
  }
  return (int)cudaGetLastError();
}

// The latent form (DV < DK, V the first DV features of each K row):
// flash_mla_kernel in the regime of R = T·H/Hkv, the decode regime's grid a
// block per (batch, KV head), split and row group of 16 rows.
template <int DK, int DV, bool kSplit>
int launch_mla(const void* q, const void* kv, const void* offsets, void* out, void* partial,
               void* counters, int B, int T, int H, int Hkv, int S, float scale, int max_splits,
               cudaStream_t stream) {
  constexpr int smem = MlaSmem<DK, DV, kSplit>::bytes;
  static const cudaError_t attr = smem_attributes(flash_mla_kernel<DK, DV, kSplit>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid = kSplit ? dim3(B * Hkv, max_splits, (T * (H / Hkv) + 15) / 16)
                           : dim3((T + mla_rows<false>() - 1) / mla_rows<false>(), B * H);
  flash_mla_kernel<DK, DV, kSplit><<<grid, mla_threads<kSplit>(), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kv),
      static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), static_cast<int*>(counters), T, H, Hkv, S, scale, max_splits);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int launch_latent(const void* q, const void* kv, const void* offsets, void* out, void* partial,
                  void* counters, int B, int T, int H, int Hkv, int S, float scale,
                  int max_splits, cudaStream_t stream) {
  if (max_splits > 0 && T * (H / Hkv) <= kLatentDecodeRows) {
    if (max_splits > kMaxSplits) return (int)cudaErrorInvalidValue;
    return launch_mla<DK, DV, true>(q, kv, offsets, out, partial, counters, B, T, H, Hkv, S,
                                    scale, max_splits, stream);
  }
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  return launch_mla<DK, DV, false>(q, kv, offsets, out, partial, counters, B, T, H, Hkv, S, scale,
                                   1, stream);
}

// the (D, DV) pairs a library instantiates: D = DV 64, 128, 256 in `flash`,
// 80 and 96 in `flash_narrow`, (192, 128) and (96, 64) in `flash_dkdv`
#if defined(TPULLM_FLASH_NARROW)
#define TPULLM_FLASH_DIMS(X) X(80, 80) X(96, 96)
#elif defined(TPULLM_FLASH_DKDV)
#define TPULLM_FLASH_DIMS(X) X(192, 128) X(96, 64)
#else
#define TPULLM_FLASH_DIMS(X) X(64, 64) X(128, 128) X(256, 256)
#endif

template <int KV>
int launch(const void* q, const void* k, const void* k_scale, const void* v,
           const void* v_scale, const void* offsets, const void* sinks, const void* slopes,
           void* out, void* partial, void* counters, int B, int T, int H, int Hkv, int S,
           int D, int DV, float scale, float softcap, int window, int max_splits,
           void* stream_ptr) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define TPULLM_FLASH_CASE(d, dv)                                                             \
  if (D == d && DV == dv)                                                                    \
    return launch_d<d, dv, KV>(q, k, k_scale, v, v_scale, offsets, sinks, slopes, out, partial, \
                               counters, B, T, H, Hkv, S, scale, softcap, window, max_splits, s);
  TPULLM_FLASH_DIMS(TPULLM_FLASH_CASE)
#undef TPULLM_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#ifndef TPULLM_FLASH_LATENT
// The dense and q8 entries at key width D and value width DV (this library:
// D = DV 64, 128 and 256; under -DTPULLM_FLASH_NARROW: D = DV 80 and 96;
// under -DTPULLM_FLASH_DKDV: (192, 128) and (96, 64)). max_splits > 0 takes
// the decode regime (R = T·H/Hkv ≤ 80, in row groups of 16), 0 the prefill
// kernel at any R; out bf16 [B, T, H, DV]; partial: f32
// [B·Hkv·max_splits·R·(DV + 2)] and counters: int32 [B·Hkv·⌈R/16⌉] (zero,
// left zero) for the decode regime; unread (may be null) in the prefill
// regime.
#define TPULLM_FLASH_DENSE(name, KV)                                                        \
  extern "C" int name(const void* q, const void* k, const void* v, const void* offsets,      \
                      const void* sinks, const void* slopes, void* out, void* partial,       \
                      void* counters, int B, int T, int H, int Hkv, int S, int D, int DV,    \
                      float scale, float softcap, int window, int max_splits, void* stream) { \
    return launch<KV>(q, k, nullptr, v, nullptr, offsets, sinks, slopes, out, partial,       \
                      counters, B, T, H, Hkv, S, D, DV, scale, softcap, window, max_splits,  \
                      stream);                                                               \
  }

// a dense cache: q bf16, k and v of the entry's type
TPULLM_FLASH_DENSE(tpullm_flash_bf16, kKvBf16)
TPULLM_FLASH_DENSE(tpullm_flash_f16, kKvF16)
TPULLM_FLASH_DENSE(tpullm_flash_f32, kKvF32)

extern "C" int tpullm_flash_q8(const void* q, const void* k_q, const void* k_s,
                               const void* v_q, const void* v_s, const void* offsets,
                               const void* sinks, const void* slopes, void* out, void* partial,
                               void* counters, int B, int T, int H, int Hkv, int S, int D,
                               int DV, float scale, float softcap, int window, int max_splits,
                               void* stream) {
  return launch<kKvQ8>(q, k_q, k_s, v_q, v_s, offsets, sinks, slopes, out, partial, counters, B,
                      T, H, Hkv, S, D, DV, scale, softcap, window, max_splits, stream);
}

#else  // the latent form's library (its own nvcc, built beside the one above)

// q bf16 [B, T, H, DK], kv the bf16 latent [B, Hkv, S, DK] whose rows' first
// DV features are V; out bf16 [B, T, H, DV]; in the decode regime (R =
// T·H/Hkv ≤ 64) partial f32 [B·Hkv·max_splits·R·(DV + 2)] and counters
// int32 [B·Hkv·⌈R/16⌉] (zero, left zero); max_splits 0 takes the prefill
// kernel at any R (so that chip_smoke.py can time it against the decode
// regime at one call). (DK, DV) = (576, 512) or (288, 256).
extern "C" int tpullm_flash_latent_bf16(const void* q, const void* kv, const void* offsets,
                                        void* out, void* partial, void* counters, int B, int T,
                                        int H, int Hkv, int S, int DK, int DV, float scale,
                                        int max_splits, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (DK == 576 && DV == 512)
    return launch_latent<576, 512>(q, kv, offsets, out, partial, counters, B, T, H, Hkv, S, scale,
                                   max_splits, s);
  if (DK == 288 && DV == 256)
    return launch_latent<288, 256>(q, kv, offsets, out, partial, counters, B, T, H, Hkv, S, scale,
                                   max_splits, s);
  return (int)cudaErrorInvalidValue;
}

#endif
