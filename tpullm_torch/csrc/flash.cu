// Causal online-softmax attention over the head-major KV cache, for Hopper.
//
// Replaces the TPU kernel tpullm/ops/pallas/flash.py::_make_kernel, launched
// by _run: quant=false (bf16 K/V, entry flash_attention) and quant=true (int8
// K/V with one f32 scale per position, entry flash_attention_q8). Semantics
// kept from the TPU kernel: per-batch offsets (query row t sits at position
// off + t, kv_len = off + T), GQA by h / (H / Hkv), optional softcap (tanh),
// sliding window, ALiBi slope_h · (k_pos − q_pos), per-head sink logits
// folded into the normalizer at finalize, NEG_INF = -1e30 rather than -inf,
// and safe = l > 0 ? l : 1.
//
// What bounds it on the card: at decode the K/V bytes a head group reads
// (kv_len · D · 2 bytes each for K and V in bf16, about half that in q8);
// at prefill the QK and PV products (done on CUDA cores here, no tensor
// cores yet). Design: grid (B·H, ⌈T/16⌉); a block of four warps holds a
// 16-row Q tile in shared memory and sweeps 32-key K/V tiles from the
// window start to the last key its rows can see, so a short context in a
// long cache pays for kv_len, not S, and T = 1 and any S need no padding.
// Each warp owns four query rows; a lane owns one key of the tile for the
// scores and D/32 output features for the accumulator, with the online
// softmax state (m, l, acc) in registers.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTQ = 16;                  // query rows per block
constexpr int kTK = 32;                  // keys per tile (one per lane)
constexpr int kRowsPerWarp = kTQ / kWarps;
constexpr float kNegInf = -1e30f;

template <int D, bool kQ8>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const __nv_bfloat16* __restrict__ q,   // [B, T, H, D]
             const void* __restrict__ k_ptr,         // [B, Hkv, S, D] bf16 | int8
             const void* __restrict__ v_ptr,         // [B, Hkv, S, D] bf16 | int8
             const float* __restrict__ k_scale,      // [B, Hkv, S] (q8)
             const float* __restrict__ v_scale,      // [B, Hkv, S] (q8)
             const int* __restrict__ offsets,        // [B]
             const float* __restrict__ sinks,        // [H] or null
             const float* __restrict__ slopes,       // [H] or null
             __nv_bfloat16* __restrict__ out,        // [B, T, H, D]
             int T, int H, int Hkv, int S, float scale, float softcap, int window) {
  constexpr int DC = D / 32;  // accumulator features per lane
  __shared__ float qs[kTQ][D];
  __shared__ float ks[kTK][D + 1];  // padded: lanes read different rows
  __shared__ float vs[kTK][D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int t0 = blockIdx.y * kTQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int off = offsets[b];
  const int nrows = min(kTQ, T - t0);

  for (int i = threadIdx.x; i < kTQ * D; i += kWarps * 32) {
    const int r = i / D, d = i % D;
    qs[r][d] = r < nrows ? __bfloat162float(q[(((size_t)b * T + t0 + r) * H + h) * D + d]) : 0.f;
  }

  // keys any row of this block can see: [first row's window start, last row]
  const int q_first = off + t0, q_last = off + t0 + nrows - 1;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / kTK) * kTK;
  const int k_end = min(S, q_last + 1);

  const size_t kv_row0 = ((size_t)b * Hkv + hk) * S;
  const float slope = slopes != nullptr ? slopes[h] : 0.f;

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += kTK) {
    __syncthreads();  // previous tile's readers are done
    if (kQ8) {
      // 16 int8 features per load
      const int8_t* kq = static_cast<const int8_t*>(k_ptr);
      const int8_t* vq = static_cast<const int8_t*>(v_ptr);
      for (int i = threadIdx.x; i < kTK * D / 16; i += kWarps * 32) {
        const int r = i / (D / 16), d0 = (i % (D / 16)) * 16;
        const int pos = kt + r;
        if (pos < k_end) {
          const size_t row = kv_row0 + pos;
          const int4 kr = *reinterpret_cast<const int4*>(kq + row * D + d0);
          const int4 vr = *reinterpret_cast<const int4*>(vq + row * D + d0);
          const int8_t* kb = reinterpret_cast<const int8_t*>(&kr);
          const int8_t* vb = reinterpret_cast<const int8_t*>(&vr);
          const float ksc = k_scale[row], vsc = v_scale[row];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            ks[r][d0 + j] = (float)kb[j] * ksc;
            vs[r][d0 + j] = (float)vb[j] * vsc;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) ks[r][d0 + j] = vs[r][d0 + j] = 0.f;
        }
      }
    } else {
      // 8 bf16 features per load
      const __nv_bfloat16* kb16 = static_cast<const __nv_bfloat16*>(k_ptr);
      const __nv_bfloat16* vb16 = static_cast<const __nv_bfloat16*>(v_ptr);
      for (int i = threadIdx.x; i < kTK * D / 8; i += kWarps * 32) {
        const int r = i / (D / 8), d0 = (i % (D / 8)) * 8;
        const int pos = kt + r;
        if (pos < k_end) {
          const size_t row = kv_row0 + pos;
          const uint4 kr = *reinterpret_cast<const uint4*>(kb16 + row * D + d0);
          const uint4 vr = *reinterpret_cast<const uint4*>(vb16 + row * D + d0);
          const __nv_bfloat16* kh = reinterpret_cast<const __nv_bfloat16*>(&kr);
          const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            ks[r][d0 + j] = __bfloat162float(kh[j]);
            vs[r][d0 + j] = __bfloat162float(vh[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) ks[r][d0 + j] = vs[r][d0 + j] = 0.f;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= nrows) break;  // uniform across the warp
      const int q_pos = off + t0 + r;
      const int k_pos = kt + lane;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      s *= scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      if (slopes != nullptr) s += slope * (float)(k_pos - q_pos);
      bool ok = k_pos <= q_pos && k_pos < k_end;
      if (window > 0) ok = ok && k_pos > q_pos - window;
      s = ok ? s : kNegInf;

      const float m_new = fmaxf(m_i[i], tpullm::warp_max(s));
      const float p = expf(s - m_new);  // a masked key next to a real max: 0
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + tpullm::warp_sum(p);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
#pragma unroll 8
      for (int j = 0; j < kTK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pj, vs[j][lane + 32 * c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= nrows) break;
    float l = l_i[i];
    float corr = 1.f;
    if (sinks != nullptr) {  // the sink column joins the normalizer only
      const float sk = sinks[h];
      const float m_f = fmaxf(m_i[i], sk);
      corr = expf(m_i[i] - m_f);
      l = l * corr + expf(sk - m_f);
    }
    const float inv = 1.f / (l > 0.f ? l : 1.f);
    __nv_bfloat16* o = out + (((size_t)b * T + t0 + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[lane + 32 * c] = __float2bfloat16_rn(acc[i][c] * corr * inv);
  }
}

template <bool kQ8>
int launch(const void* q, const void* k, const void* k_scale, const void* v,
           const void* v_scale, const void* offsets, const void* sinks,
           const void* slopes, void* out, int B, int T, int H, int Hkv, int S, int D,
           float scale, float softcap, int window, void* stream_ptr) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (T + kTQ - 1) / kTQ);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define TPULLM_FLASH_ARGS                                                              \
  static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(k_scale),      \
      static_cast<const float*>(v_scale), static_cast<const int*>(offsets),            \
      static_cast<const float*>(sinks), static_cast<const float*>(slopes),             \
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, S, scale, softcap, window
  switch (D) {
    case 64: flash_kernel<64, kQ8><<<grid, kWarps * 32, 0, stream>>>(TPULLM_FLASH_ARGS); break;
    case 128: flash_kernel<128, kQ8><<<grid, kWarps * 32, 0, stream>>>(TPULLM_FLASH_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TPULLM_FLASH_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tpullm_flash_bf16(const void* q, const void* k, const void* v,
                                 const void* offsets, const void* sinks,
                                 const void* slopes, void* out, int B, int T, int H,
                                 int Hkv, int S, int D, float scale, float softcap,
                                 int window, void* stream) {
  return launch<false>(q, k, nullptr, v, nullptr, offsets, sinks, slopes, out, B, T,
                       H, Hkv, S, D, scale, softcap, window, stream);
}

extern "C" int tpullm_flash_q8(const void* q, const void* k_q, const void* k_s,
                               const void* v_q, const void* v_s, const void* offsets,
                               const void* sinks, const void* slopes, void* out, int B,
                               int T, int H, int Hkv, int S, int D, float scale,
                               float softcap, int window, void* stream) {
  return launch<true>(q, k_q, k_s, v_q, v_s, offsets, sinks, slopes, out, B, T, H,
                      Hkv, S, D, scale, softcap, window, stream);
}
