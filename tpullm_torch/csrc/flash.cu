// Causal online-softmax attention over the head-major KV cache, for Hopper.
//
// Replaces the TPU kernel tpullm/ops/pallas/flash.py::_make_kernel, launched
// by _run: quant=false (bf16 K/V, entry flash_attention) and quant=true (int8
// K/V with one f32 scale per position, entry flash_attention_q8). Semantics
// kept from the TPU kernel: per-batch offsets (query row t sits at position
// off + t, kv_len = off + T), GQA by h / (H / Hkv), optional softcap (tanh)
// before ALiBi slope_h · (k_pos − q_pos) and the mask, sliding window,
// per-head sink logits folded into the normalizer only, NEG_INF = -1e30 as
// the running max before any key, safe = l > 0 ? l : 1, and keys read up to
// kv_len, never S. A masked key adds exactly 0 (its score is −inf), so a
// stretch of keys that a row cannot see leaves (m, l, acc) = (−1e30, 0, 0).
//
// Two regimes, picked before the launch from the query rows that share one
// KV head, R = T · (H / Hkv) (ops/kernels/flash.py regime()):
//
// R ≤ kDecodeRows = 16 (decode; the 8B's T = 1 is R = 4): split-KV on CUDA
//   cores, flash_decode_kernel. What bounds it: the K/V bytes up to kv_len
//   (2 · kv_len · D · 2 bytes a KV head in bf16, half that plus the scales
//   in q8). One block per (batch, KV head, split): the R rows of the G
//   heads of one KV head share every K/V tile, so each is read once (the
//   old grid read it G times). Each batch's key range [window start,
//   kv_len) is cut into splits of whole 64-key tiles (kv_split, mirrored by
//   ops/kernels/flash.py kv_splits): as many as max_splits, which the
//   wrapper sizes so that B · Hkv · max_splits blocks cover the card about
//   twice; a short context gets fewer (kv_len 38 one, kv_len 3001 sixteen,
//   at B = 2, Hkv = 8). Splits of 16 or 32 keys were tried on the card and
//   lost: below a tile the merge they add costs more than the parallelism
//   gives, so a short context is latency-bound by one block's pass over one
//   tile (the launch, the scores, the softmax, P·V).
//   256 threads a block: in the scores, thread = (key, row group of 4), so
//   the 8B's R = 4 is one row a thread; q is held once as f32 in shared
//   memory. K/V tiles go 16 bytes a thread into a 2-stage cp.async ring.
//   Scores, softmax and P·V are f32 FMAs (no new rounding point; int8 codes
//   are exact in f32). A split writes f32 (m, l, acc) partials; the last
//   block of each (batch, KV head) to finish, found through a counter of the
//   launch's stream (ops/kernels/_build.py counters) that it resets, merges
//   them in split order (deterministic), folds in the sink
//   column, divides by safe l and rounds to bf16. The combine runs in the
//   same launch rather than as a second kernel because decode is host-bound
//   (the card idles most of a token): a second launch a layer would cost
//   the host as much as the kernel costs the card. A batch with one split
//   finishes without partials.
//
// R > 16 (prefill): flash_prefill_kernel, tensor cores, FlashAttention-2
//   layout. What bounds it: the QK and PV products, 4 · D · (visible pairs)
//   · H FLOP against 989 TFLOP/s. A block of 4 warps holds 64 query rows of
//   one head, each warp 16 rows; 64-key K/V tiles go through a 2-stage
//   cp.async ring and are read by ldmatrix; QK and PV are mma.sync
//   m16n8k16 with bf16 inputs and f32 sums; the online softmax stays in
//   registers. Tiles wholly above the block's causal diagonal or before its
//   window are never loaded; a warp skips the tiles wholly above its own
//   diagonal or before its own window, and masks only tiles that straddle
//   an edge. q8: the int8 codes are exact in bf16 (a conversion pass per
//   tile in shared memory); the per-key K scale multiplies the f32 score
//   after the product; the per-key V scale folds into p. The new rounding
//   point, p (or p · v_s) to bf16 for the PV product, is carried as two bf16
//   terms, hi = bf16(p), lo = bf16(p − hi), so p is kept to about 16 bits
//   against f32's 24; the JAX kernel multiplies in f32.

#include "common.cuh"

namespace {

using namespace tpullm;

constexpr float kNegInf = -1e30f;  // the running max before any key
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDecodeRows = 16;    // R = T·G at most this: the decode regime
constexpr int kDecThreads = 256;  // 64 keys × 4 row groups in the scores
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecTK = 64;         // keys a tile (decode)
constexpr int kDecStages = 2;
constexpr int kMaxSplits = 64;     // splits of one (batch, KV head) at most
constexpr int kPreThreads = 128;   // 4 warps × 16 query rows
constexpr int kPreBM = 64;         // query rows a prefill block
constexpr int kPreTK = 64;         // keys a tile (prefill)
constexpr int kPreStages = 2;

__device__ __forceinline__ float exp_e(float x) { return exp2f(x * kLog2e); }

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

// four bf16 (8 bytes) or four int8 (4 bytes) of shared memory → f32
template <bool kQ8>
__device__ __forceinline__ void load4(const char* p, float (&v)[4]) {
  if constexpr (kQ8) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = code_f32(w, c);
  } else {
    load_bf16x4(reinterpret_cast<const __nv_bfloat16*>(p), v);
  }
}

// Finishes one decode row from its merged (m, l, acc) for features 4·dq ..:
// the sink column in the normalizer only, safe l, bf16 to out[b, t, h].
__device__ __forceinline__ void decode_finish(__nv_bfloat16* __restrict__ out, int b, int T,
                                              int H, int h, int t, int D, int dq, float m,
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
  *reinterpret_cast<uint2*>(out + (((size_t)b * T + t) * H + h) * D + 4 * dq) = w;
}

// Shared memory of a decode block: q rows (f32), the K/V ring (K rows padded
// by 16 bytes so that 8 lanes reading 8 keys hit distinct banks; q8: the
// per-key scales after V), the probabilities p [16][65] and per-row state.
template <int D, bool kQ8>
struct DecSmem {
  static constexpr int kEs = kQ8 ? 1 : 2;
  static constexpr int kKPitch = D * kEs + 16;
  static constexpr int kVPitch = D * kEs;
  static constexpr int kV = kDecTK * kKPitch;
  static constexpr int kScales = kV + kDecTK * kVPitch;
  static constexpr int kStage = kScales + (kQ8 ? 2 * kDecTK * 4 : 0);
  static constexpr int kPPitch = kDecTK + 1;
  static constexpr int q_off = 0;
  static constexpr int ring_off = kDecodeRows * D * 4;
  static constexpr int p_off = ring_off + kDecStages * kStage;
  static constexpr int row_off = p_off + kDecodeRows * kPPitch * 4;
  static constexpr int bytes = row_off + 4 * kDecodeRows * 4 + 16;
  static_assert(kDecStages * kStage >= 2 * kMaxSplits * kDecodeRows * 4,
                "the ring holds every split's (m, l) for the combine");
};

template <int D, bool kQ8>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, T, H, D]
                    const char* __restrict__ k,            // [B, Hkv, S, D] bf16 | int8
                    const char* __restrict__ v,
                    const float* __restrict__ k_scale,     // [B, Hkv, S] (q8)
                    const float* __restrict__ v_scale,
                    const int* __restrict__ offsets,       // [B]
                    const float* __restrict__ sinks,       // [H] or null
                    const float* __restrict__ slopes,      // [H] or null
                    __nv_bfloat16* __restrict__ out,       // [B, T, H, D]
                    float* __restrict__ partial,           // [B·Hkv, max_splits, R, D + 2]
                    int* __restrict__ counters,            // [B·Hkv], zero between launches
                    int T, int H, int Hkv, int S, float scale, float softcap, int window,
                    int max_splits) {
  using L = DecSmem<D, kQ8>;
  constexpr int RB = D * L::kEs;  // bytes of one K or V row
  constexpr int QD = D / 4;       // threads a row in P·V (4 features each)
  constexpr int RG = kDecThreads / QD;
  constexpr int RPT = kDecodeRows / RG;  // rows a thread in P·V
  extern __shared__ __align__(16) char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  char* ring = smem + L::ring_off;
  float* ps = reinterpret_cast<float*>(smem + L::p_off);
  float* corr_s = reinterpret_cast<float*>(smem + L::row_off);
  float* m_s = corr_s + kDecodeRows;
  float* l_s = m_s + kDecodeRows;
  int* flag = reinterpret_cast<int*>(l_s + kDecodeRows);

  const int grp = blockIdx.x, b = grp / Hkv, hk = grp % Hkv, z = blockIdx.y;
  const int G = H / Hkv, R = T * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = offsets[b];
  const KvSplit sp = kv_split(off, T, S, window, max_splits);
  if (z >= sp.n) return;
  const int k0 = sp.lo + z * sp.per, k1 = min(sp.hi, k0 + sp.per);
  const int ntiles = (k1 - k0 + kDecTK - 1) / kDecTK;  // ≥ 1 but for an empty range

  const size_t kv_row0 = ((size_t)b * Hkv + hk) * S;
  const char* kb = k + kv_row0 * RB;
  const char* vb = v + kv_row0 * RB;
  auto load_tile = [&](int it) {
    char* st = ring + (it % kDecStages) * L::kStage;
    const int kt = k0 + it * kDecTK;
    for (int i = tid; i < kDecTK * (RB / 16); i += kDecThreads) {
      const int r = i / (RB / 16), seg = (i % (RB / 16)) * 16;
      const bool ok = kt + r < k1;
      const size_t src = (size_t)(ok ? kt + r : kt) * RB + seg;
      cp_async16(st + r * L::kKPitch + seg, kb + src, ok ? 16 : 0);
      cp_async16(st + L::kV + r * L::kVPitch + seg, vb + src, ok ? 16 : 0);
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
  // q rows r = t·G + g (head hk·G + g, query t) as f32, once (the scores
  // read each of them for every key), rows past R zero
  for (int i = tid; i < kDecodeRows * (D / 8); i += kDecThreads) {
    const int r = i / (D / 8), seg = (i % (D / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < R) {
      const __nv_bfloat16* qr = q + (((size_t)b * T + r / G) * H + hk * G + r % G) * D + seg;
      load_bf16x4(qr, f);
      load_bf16x4(qr + 4, f + 4);
    }
    *reinterpret_cast<float4*>(qs + r * D + seg) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(qs + r * D + seg + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }

  // scores: thread = key j of the tile, rows grp + kGroups·i; softmax: warp
  // w, rows w + kDecWarps·i; P·V: features 4·(tid % QD) .., rows tid / QD +
  // RG·i
  constexpr int kGroups = kDecThreads / kDecTK;
  const int j = tid % kDecTK, grp_r = tid / kDecTK;
  const int dq = tid % QD, rg = tid / QD;
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
    if (it + 1 < ntiles) load_tile(it + 1);
    cp_async_commit();
    const char* st = ring + (it % kDecStages) * L::kStage;
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
        if constexpr (kQ8) {
          const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int e = 0; e < 16; ++e) kf[e] = code_f32(words[e / 4], e % 4);
        } else {
          const __nv_bfloat16* kh = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = __bfloat162float(kh[e]);
        }
#pragma unroll
        for (int i = 0; i < kDecodeRows / kGroups; ++i) {
          const int r = grp_r + kGroups * i;
          if (r < R) {
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
        if (r < R) {
          const int q_pos = off + r / G;
          float x = s[i] * ksc;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          if (slopes != nullptr) x += slopes[hk * G + r % G] * (float)(k_pos - q_pos);
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
      if (r < R) {
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
        if (r < R) {
          const float c = corr_s[r];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] *= c;
        }
      }
      const int nk = min(kDecTK, k1 - kt);  // keys past k1 have p = 0
#pragma unroll 4
      for (int jj = 0; jj < nk; ++jj) {
        float vv[4];
        load4<kQ8>(vt + jj * L::kVPitch, vv);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg + RG * i;
          if (r < R) {
            const float p = ps[r * L::kPPitch + jj];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kDecodeRows / kDecWarps; ++i) {
    const int r = warp + kDecWarps * i;
    if (r < R && lane == 0) {
      m_s[r] = m_r[i];
      l_s[r] = l_r[i];
    }
  }
  __syncthreads();

  if (sp.n == 1) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + RG * i;
      if (r < R) decode_finish(out, b, T, H, hk * G + r % G, r / G, D, dq, m_s[r], l_s[r], acc[i],
                               sinks);
    }
    return;
  }

  // partials of split z: acc [R][D], then (m, l) [R][2] after all the acc
  const size_t n_acc = (size_t)gridDim.x * max_splits * R * D;
  float* pacc = partial + ((size_t)grp * max_splits + z) * R * D;
  float* pml = partial + n_acc + ((size_t)grp * max_splits + z) * R * 2;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    if (r < R)
      *reinterpret_cast<float4*>(pacc + (size_t)r * D + 4 * dq) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (tid < R) {
    pml[2 * tid] = m_s[tid];
    pml[2 * tid + 1] = l_s[tid];
  }
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + grp, 1) == sp.n - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();  // the last block: every split's partials are visible

  // every split's (m, l) into the ring (free now), then each row's merged
  // max, the weights exp(m_z − m) in place of m_z, and the merged l
  const float* gacc = partial + (size_t)grp * max_splits * R * D;
  const float* gml = partial + n_acc + (size_t)grp * max_splits * R * 2;
  float* cm = reinterpret_cast<float*>(ring);  // [n][R]
  float* cl = cm + kMaxSplits * kDecodeRows;    // [n][R]
  for (int i = tid; i < sp.n * R; i += kDecThreads) {
    cm[i] = __ldcg(gml + 2 * i);
    cl[i] = __ldcg(gml + 2 * i + 1);
  }
  __syncthreads();
  if (tid < R) {
    float m = kNegInf, l = 0.f;
    for (int zz = 0; zz < sp.n; ++zz) m = fmaxf(m, cm[zz * R + tid]);
    for (int zz = 0; zz < sp.n; ++zz) {  // in split order
      const float w = exp_e(cm[zz * R + tid] - m);
      cm[zz * R + tid] = w;
      l += cl[zz * R + tid] * w;
    }
    m_s[tid] = m;
    l_s[tid] = l;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    if (r >= R) continue;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int zz = 0; zz < sp.n; ++zz) {  // in split order
      const float w = cm[zz * R + r];
      const float4 a = __ldcg(reinterpret_cast<const float4*>(gacc + ((size_t)zz * R + r) * D + 4 * dq));
      o[0] += a.x * w;
      o[1] += a.y * w;
      o[2] += a.z * w;
      o[3] += a.w * w;
    }
    decode_finish(out, b, T, H, hk * G + r % G, r / G, D, dq, m_s[r], l_s[r], o, sinks);
  }
  if (tid == 0) counters[grp] = 0;  // ready for the next launch
}

// Shared memory of a prefill block: the K/V ring, rows padded by 8 bf16 so
// that the 8 rows an ldmatrix reads fall in distinct bank groups. q8: the
// ring holds the int8 codes and the per-key scales, and one bf16 K and V
// tile takes each tile's conversion. The Q tile, read once into registers,
// is first copied into the space the second tile takes after it (ring
// stage 1; q8: the conversion tiles).
template <int D, bool kQ8>
struct PreSmem {
  static constexpr int kPitch = D + 8;  // bf16 a row of Q, K, V
  static constexpr int kTile = kPreTK * kPitch * 2;
  static constexpr int kRaw = kPreTK * D;  // bytes of one int8 K or V tile
  static constexpr int kStage = kQ8 ? 2 * kRaw + 2 * kPreTK * 4 : 2 * kTile;
  static constexpr int ring_off = 0;
  static constexpr int conv_off = kPreStages * kStage;
  static constexpr int q_off = kQ8 ? conv_off : kStage;
  static constexpr int bytes = conv_off + (kQ8 ? 2 * kTile : 0);
  static_assert(kPreBM * kPitch * 2 <= bytes - q_off, "the Q tile fits where it is copied");
};

template <int D, bool kQ8>
__global__ void __launch_bounds__(kPreThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const char* __restrict__ k,
                     const char* __restrict__ v, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ offsets,
                     const float* __restrict__ sinks, const float* __restrict__ slopes,
                     __nv_bfloat16* __restrict__ out, int T, int H, int Hkv, int S,
                     float scale, float softcap, int window) {
  using L = PreSmem<D, kQ8>;
  constexpr int P = L::kPitch;
  constexpr int RB = D * (kQ8 ? 1 : 2);  // bytes of a K or V row in the cache
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  char* ring = smem + L::ring_off;

  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * kPreBM;
  const int off = offsets[b];
  const int nrows = min(kPreBM, T - t0);
  const int q_first = off + t0, q_last = off + t0 + nrows - 1;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int k_end = min(S, q_last + 1);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kPreTK - 1) / kPreTK : 0;

  const size_t kv_row0 = ((size_t)b * Hkv + hk) * S;
  const char* kb = k + kv_row0 * RB;
  const char* vb = v + kv_row0 * RB;
  auto load_tile = [&](int it) {
    char* st = ring + (it % kPreStages) * L::kStage;
    const int kt = k_begin + it * kPreTK;
    for (int i = tid; i < kPreTK * (RB / 16); i += kPreThreads) {
      const int r = i / (RB / 16), seg = (i % (RB / 16)) * 16;
      const bool ok = kt + r < k_end;
      const size_t src = (size_t)(ok ? kt + r : kt) * RB + seg;
      if constexpr (kQ8) {
        cp_async16(st + r * D + seg, kb + src, ok ? 16 : 0);
        cp_async16(st + L::kRaw + r * D + seg, vb + src, ok ? 16 : 0);
      } else {
        cp_async16(st + r * P * 2 + seg, kb + src, ok ? 16 : 0);
        cp_async16(st + L::kTile + r * P * 2 + seg, vb + src, ok ? 16 : 0);
      }
    }
    if constexpr (kQ8) {
      for (int i = tid; i < 2 * kPreTK; i += kPreThreads) {
        const int r = i % kPreTK;
        const bool ok = kt + r < k_end;
        const float* src = (i < kPreTK ? k_scale : v_scale) + kv_row0 + (ok ? kt + r : kt);
        cp_async4(st + 2 * L::kRaw + i * 4, src, ok ? 4 : 0);
      }
    }
  };

  // the Q tile (rows past T zero) and the first K/V tile
  for (int i = tid; i < kPreBM * (D / 8); i += kPreThreads) {
    const int r = i / (D / 8), seg = (i % (D / 8)) * 8;
    const int t = t0 + min(r, nrows - 1);
    cp_async16(qs + r * P + seg, q + (((size_t)b * T + t) * H + h) * D + seg, r < nrows ? 16 : 0);
  }
  if (ntiles > 0) load_tile(0);
  cp_async_commit();

  // this warp's rows: 16·warp .. of the block; this thread's two rows
  const int w_rows = min(16, nrows - 16 * warp);
  const int w_first = q_first + 16 * warp, w_last = w_first + w_rows - 1;
  const int qa = w_first + (lane >> 2), qb = qa + 8;
  // the softmax runs in log2 units (scores times log2 e), so that each p is
  // one exp2: the scale, the softcap and the ALiBi slope carry the factor
  const float scale2 = scale * kLog2e, cap2 = softcap * kLog2e;
  const float inv_cap2 = softcap > 0.f ? 1.f / cap2 : 0.f;
  const float slope2 = slopes != nullptr ? slopes[h] * kLog2e : 0.f;

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it (and Q) landed; every reader of tile it-1 is done
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], qs + (16 * warp + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
      __syncthreads();  // every warp holds its Q rows: their space takes tile 1
    }
    if (it + 1 < ntiles) load_tile(it + 1);
    cp_async_commit();
    const char* st = ring + (it % kPreStages) * L::kStage;
    const int kt = k_begin + it * kPreTK;
    const __nv_bfloat16* kt_s;
    const __nv_bfloat16* vt_s;
    if constexpr (kQ8) {  // int8 codes → bf16 (exact)
      __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(smem + L::conv_off);
      for (int i = tid; i < 2 * kPreTK * (D / 16); i += kPreThreads) {
        const int which = i / (kPreTK * (D / 16)), rem = i % (kPreTK * (D / 16));
        const int r = rem / (D / 16), seg = (rem % (D / 16)) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(st + which * L::kRaw + r * D + seg);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
        __nv_bfloat16* dst = conv + which * (L::kTile / 2) + r * P + seg;
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const __nv_bfloat162 pr = __floats2bfloat162_rn(code_f32(words[e / 2], 2 * (e % 2)),
                                                          code_f32(words[e / 2], 2 * (e % 2) + 1));
          w[e] = *reinterpret_cast<const uint32_t*>(&pr);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      kt_s = conv;
      vt_s = conv + L::kTile / 2;
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
        uint32_t r[4];
        ldmatrix_x4(r, kt_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    const float* kss = reinterpret_cast<const float*>(st + 2 * L::kRaw);  // q8 only
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
    for (int dt = 0; dt < D / 8; ++dt) {
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
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt_s + (ks * 16 + (lane & 15)) * P + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a_hi, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], a_hi, r[2], r[3]);
        mma_bf16(o[2 * dp], a_lo, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], a_lo, r[2], r[3]);
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
    const int t = t0 + 16 * warp + (lane >> 2) + 8 * i;
    if (t >= T) continue;
    __nv_bfloat16* dst = out + (((size_t)b * T + t) * H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(o[dt][2 * i] * inv[i], o[dt][2 * i + 1] * inv[i]);
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

template <int D, bool kQ8>
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
  if (T * (H / Hkv) <= kDecodeRows) {
    if (max_splits < 1 || max_splits > kMaxSplits) return (int)cudaErrorInvalidValue;
    constexpr int smem = DecSmem<D, kQ8>::bytes;
    static const cudaError_t attr = smem_attributes(flash_decode_kernel<D, kQ8>, smem);
    if (attr != cudaSuccess) return (int)attr;
    flash_decode_kernel<D, kQ8><<<dim3(B * Hkv, max_splits), kDecThreads, smem, stream>>>(
        qb, kb, vb, ks, vs, ob, sk, sl, o, static_cast<float*>(partial),
        static_cast<int*>(counters), T, H, Hkv, S, scale, softcap, window, max_splits);
  } else {
    if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
    constexpr int smem = PreSmem<D, kQ8>::bytes;
    static const cudaError_t attr = smem_attributes(flash_prefill_kernel<D, kQ8>, smem);
    if (attr != cudaSuccess) return (int)attr;
    flash_prefill_kernel<D, kQ8><<<dim3((T + kPreBM - 1) / kPreBM, B * H), kPreThreads, smem,
                                   stream>>>(qb, kb, vb, ks, vs, ob, sk, sl, o, T, H, Hkv, S,
                                             scale, softcap, window);
  }
  return (int)cudaGetLastError();
}

template <bool kQ8>
int launch(const void* q, const void* k, const void* k_scale, const void* v,
           const void* v_scale, const void* offsets, const void* sinks, const void* slopes,
           void* out, void* partial, void* counters, int B, int T, int H, int Hkv, int S,
           int D, float scale, float softcap, int window, int max_splits, void* stream_ptr) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (D) {
    case 64:
      return launch_d<64, kQ8>(q, k, k_scale, v, v_scale, offsets, sinks, slopes, out, partial,
                               counters, B, T, H, Hkv, S, scale, softcap, window, max_splits, s);
    case 128:
      return launch_d<128, kQ8>(q, k, k_scale, v, v_scale, offsets, sinks, slopes, out,
                                partial, counters, B, T, H, Hkv, S, scale, softcap, window,
                                max_splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// partial: f32 [B·Hkv·max_splits·R·(D + 2)] and counters: int32 [B·Hkv]
// (zero, left zero) for the decode regime, R = T·H/Hkv ≤ 16; unread (may be
// null) in the prefill regime.
extern "C" int tpullm_flash_bf16(const void* q, const void* k, const void* v,
                                 const void* offsets, const void* sinks, const void* slopes,
                                 void* out, void* partial, void* counters, int B, int T, int H,
                                 int Hkv, int S, int D, float scale, float softcap, int window,
                                 int max_splits, void* stream) {
  return launch<false>(q, k, nullptr, v, nullptr, offsets, sinks, slopes, out, partial,
                       counters, B, T, H, Hkv, S, D, scale, softcap, window, max_splits, stream);
}

extern "C" int tpullm_flash_q8(const void* q, const void* k_q, const void* k_s,
                               const void* v_q, const void* v_s, const void* offsets,
                               const void* sinks, const void* slopes, void* out, void* partial,
                               void* counters, int B, int T, int H, int Hkv, int S, int D,
                               float scale, float softcap, int window, int max_splits,
                               void* stream) {
  return launch<true>(q, k_q, k_s, v_q, v_s, offsets, sinks, slopes, out, partial, counters, B,
                      T, H, Hkv, S, D, scale, softcap, window, max_splits, stream);
}
