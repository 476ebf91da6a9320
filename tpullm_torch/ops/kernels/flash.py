"""The flash-attention kernels over the head-major KV cache, and their plain
versions.

Replaces tpullm/ops/pallas/flash.py::_make_kernel (the pallas_call in _run):
the dense-KV instantiation (quant=False, entry flash_attention, on a bf16,
f16 or f32 cache, which the JAX kernel upcasts to f32) and the
int8+scale-KV instantiation (quant=True, entry flash_attention_q8). Source:
tpullm_torch/csrc/flash.cu, in two regimes picked by `regime` from the query
rows that share one KV head, R = T·H/Hkv: up to DECODE_ROWS, and at T = 1
up to DECODE_MAX_ROWS (Falcon-7B's 71 heads on one KV head), the split-KV
decode kernel (CUDA cores; bound: the K/V bytes up to kv_len; a block a row
group of DECODE_ROWS rows, a split counter each), otherwise the
tensor-core prefill kernel (bound: the QK and PV products). Head dims Dk =
Dv 64, 128 and 256 in the library `flash`, 80 and 96 (Phi-2, Phi-3) in
`flash_narrow`, and key width Dk ≠ value width Dv at (192, 128) and
(96, 64) (the decompressed MLA form of DeepSeek-V2 / PLM and of MiniCPM3)
in `flash_dkdv`: the same source built apart so that the three compile
side by side.

Layouts as in the JAX package: q [B, T, H, Dk] (caller layout), k
[B, Hkv, S, Dk] and v [B, Hkv, S, Dv] (cache layout), k_s/v_s [B, Hkv, S]
f32, offsets [B] int32 (query row t sits at position off_b + t; kv_len_b =
off_b + T); the output [B, T, H, Dv].

The latent form (the MLA cache, runtime/kvcache.py MLACache): (Dk, Dv) =
(576, 512) (DeepSeek-V2/V3, PLM) or (288, 256) (MiniCPM3) on a bf16 cache
of one KV head, v a view of k's first Dv features (`is_latent`). Its own
library (`flash_latent`): csrc/flash.cu flash_mla_kernel, both regimes on
the tensor cores (the decode regime split over the keys as above, p for the
PV product as two bf16 terms in both: `flash_split_reference(...,
p_terms=2)` is its decode order's plain version). Its decode regime takes
up to LATENT_DECODE_ROWS = 64 rows (`regime(..., latent=True)`), in blocks
of 16 rows each (row groups): every head of a latent shares its one KV
head, so MiniCPM3's 40 heads make R = 40 at T = 1, and the prefill grid
would read the whole latent once for each of them without splitting the
keys. A row group changes no row's order: the plain version is the same
split plan for every R.

`flash_reference` computes the same function densely in f32 and casts the
output to q's dtype; rows that see no key give 0. It is what a CPU tensor
takes. Beside it, the plain versions of the kernels' own orders:
`flash_split_reference` builds the decode regime's per-split f32 partials
on the kernel's split plan (`max_splits`, `kv_splits`) and merges them as
the kernel does; `flash_prefill_reference` runs the prefill regime's
64-key tiles with p rounded as that kernel rounds it for the PV product.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the KV formats of the kernels: the dense cache dtypes, then int8 + scales
DENSE_FORMATS = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
FORMATS = (*DENSE_FORMATS.values(), "q8")
_HEAD_DIMS = (64, 80, 96, 128, 256)  # the head dims Dk = Dv csrc/flash.cu instantiates
NARROW_DIMS = (80, 96)  # those of its library `flash_narrow` (-DTPULLM_FLASH_NARROW)
DKDV_DIMS = ((192, 128), (96, 64))  # (Dk, Dv), Dk ≠ Dv: `flash_dkdv` (-DTPULLM_FLASH_DKDV)
LATENT_DIMS = ((576, 512), (288, 256))  # (Dk, Dv) of the latent form it instantiates (bf16)


def dims_key(d: int, dv: int) -> str:
    """The head dims' part of a LAUNCHES key: "d128", or "d576v512"."""
    return f"d{d}" if d == dv else f"d{d}v{dv}"


# launches of the kernels by KV format, head dims and regime
# ("bf16.d256.decode", "q8.d192v128.decode", "bf16.d576v512.prefill"),
# plain counts a run can read; launch_total sums them
LAUNCHES = {f"{fmt}.{dims_key(d, dv)}.{r}": 0 for fmt in FORMATS
            for d, dv in (*((d, d) for d in _HEAD_DIMS), *DKDV_DIMS)
            for r in ("decode", "prefill")}
LAUNCHES.update({f"bf16.{dims_key(d, dv)}.{r}": 0 for d, dv in LATENT_DIMS
                 for r in ("decode", "prefill")})
# calls ops.attention sent to its dense path on the card because the kernel
# does not take their head dims (`takes`), and Llama 4's chunked layers over
# a cache of more than one chunk (attention_chunked), by KV format; 0 on a
# model whose heads the kernel takes and whose cache holds one chunk
ATTN_DENSE_ROUTES = dict.fromkeys(FORMATS, 0)
# calls of the sliding-window layers of an iSWA ring cache on the card
# (ops/attention.py attention_ring: dense attention under the ring's mask,
# the JAX package's own route for them), by KV format
ATTN_RING_ROUTES = dict.fromkeys(FORMATS, 0)

DECODE_ROWS = 16  # csrc/flash.cu kDecodeRows: a decode block's rows (a row group)
# kDecodeMaxRows: a decode token's R = H/Hkv up to this takes the decode
# regime in row groups. A forward of T ≥ 2 above DECODE_ROWS stays on the
# prefill kernel, as before the row groups (verify and prefill launches
# unchanged; which kernel is faster there is not measured)
DECODE_MAX_ROWS = 80
LATENT_DECODE_ROWS = 64  # kLatentDecodeRows: the latent form's decode regime, rows of 16
DECODE_TILE = 64  # keys a decode tile (kDecTK): splits are whole tiles
MAX_SPLITS = 64  # splits of one (batch, KV head) at most (kMaxSplits)
PREFILL_TILE = 64  # keys a prefill tile (kPreTK)
PREFILL_ROWS = 64  # query rows a prefill block (kPreBM)
NEG_INF = -1e30  # the running max before any key

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DENSE_ARGS = (_P,) * 9 + (_I,) * 7 + (_F, _F, _I, _I, _P)
_Q8_ARGS = (_P,) * 11 + (_I,) * 7 + (_F, _F, _I, _I, _P)
_LATENT_ARGS = (_P,) * 6 + (_I,) * 7 + (_F, _I, _P)


def regime(T: int, H: int, Hkv: int, latent: bool = False) -> str:
    """The kernel a call takes: "decode" (split-KV) when the query rows
    sharing one KV head, R = T·H/Hkv, are at most DECODE_ROWS, or at most
    DECODE_MAX_ROWS at T = 1 (the latent form: LATENT_DECODE_ROWS at any
    T), else "prefill"."""
    R = T * (H // Hkv)
    if latent:
        return "decode" if R <= LATENT_DECODE_ROWS else "prefill"
    return "decode" if R <= DECODE_ROWS or (T == 1 and R <= DECODE_MAX_ROWS) else "prefill"


def max_splits(B: int, Hkv: int, S: int, n_sm: int) -> int:
    """The decode grid's splits per (batch, KV head): enough blocks to cover
    the card's n_sm SMs about twice, at most one a tile of S and at most
    MAX_SPLITS."""
    return max(1, min(MAX_SPLITS, -(-S // DECODE_TILE), -(-2 * n_sm // (B * Hkv))))


def kv_splits(off: int, T: int, S: int, window: int, n_max: int) -> list[tuple[int, int]]:
    """The decode kernel's splits of one batch (csrc/flash.cu kv_split): its
    keys [window start of the first row, kv_len) in whole DECODE_TILE tiles,
    at most n_max splits of equal tile counts, each [k0, k1) holding a key."""
    lo = max(0, off - window + 1) if window > 0 else 0
    hi = min(S, off + T)
    tiles = max(1, -(-(hi - lo) // DECODE_TILE))
    per = -(-tiles // min(n_max, tiles)) * DECODE_TILE
    n = -(-tiles * DECODE_TILE // per)
    return [(lo + z * per, min(hi, lo + (z + 1) * per)) for z in range(n)]


def flash_reference(q, k, v, offsets, scale: float, softcap: float = 0.0,
                    sliding_window: int = 0, sinks=None, alibi_slopes=None,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """Dense f32 attention with the kernel's semantics; with k_scale/v_scale
    the K/V are int8 codes dequantized as code · scale[pos]."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.float() if k_scale is None else k.float() * k_scale.float()[..., None]
    vf = v.float() if v_scale is None else v.float() * v_scale.float()[..., None]
    qf = q.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bhsd->bhgts", qf, kf) * scale  # [B, Hkv, G, T, S]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = offsets.to(torch.int64)[:, None] + torch.arange(T, device=q.device)[None]
    k_pos = torch.arange(S, device=q.device)
    if alibi_slopes is not None:
        dist = (k_pos[None, None, :] - q_pos[:, :, None]).float()  # [B, T, S]
        s = s + alibi_slopes.float().reshape(Hkv, G)[None, :, :, None, None] * dist[:, None, None]
    mask = k_pos[None, None, :] <= q_pos[:, :, None]
    if sliding_window > 0:
        mask &= k_pos[None, None, :] > q_pos[:, :, None] - sliding_window
    mask = mask[:, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1)  # [B, Hkv, G, T]
    if sinks is not None:
        m = torch.maximum(m, sinks.float().reshape(Hkv, G)[None, :, :, None])
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    if sinks is not None:
        l = l + torch.exp(sinks.float().reshape(Hkv, G)[None, :, :, None] - m)
    out = torch.einsum("bhgts,bhsd->bthgd", e, vf)
    out = out / torch.where(l > 0, l, torch.ones_like(l)).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, H, v.shape[-1]).to(q.dtype)


def _masked_scores(qf, kf, k_scale, q_pos, k_pos, scale, softcap, window, slopes):
    """Scores [Hkv, G, T, n] of f32 q rows [T, Hkv, G, D] against keys
    [Hkv, n, D] at positions k_pos, as the kernels form them: the product,
    times the K scale (q8) and the softmax scale, softcap, ALiBi, and −inf
    where the causal mask or the window hides the key."""
    s = torch.einsum("thgd,hnd->hgtn", qf, kf)
    if k_scale is not None:
        s = s * k_scale[:, None, None, :]
    s = s * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    dist = (k_pos[None, :] - q_pos[:, None]).float()  # [T, n]
    if slopes is not None:
        s = s + slopes.reshape(qf.shape[1], qf.shape[2])[:, :, None, None] * dist
    ok = dist <= 0
    if window > 0:
        ok &= dist > -window
    return s.masked_fill(~ok, float("-inf"))


def _finish(m, l, acc, sinks, Hkv, G):
    """Output [T, H, Dv] f32 of merged (m, l [Hkv, G, T], acc [Hkv, G, T,
    Dv]): the sink column in the normalizer only, then acc / safe l."""
    if sinks is not None:
        sk = sinks.float().reshape(Hkv, G)[:, :, None]
        m_f = torch.maximum(m, sk)
        c = torch.exp(m - m_f)
        l = l * c + torch.exp(sk - m_f)
        acc = acc * c[..., None]
    acc = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    T, Dv = acc.shape[2], acc.shape[3]
    return acc.permute(2, 0, 1, 3).reshape(T, Hkv * G, Dv)


def _kv(k, v, k_scale, v_scale, b, k0, k1):
    kf, vf = k[b, :, k0:k1].float(), v[b, :, k0:k1].float()
    ks = None if k_scale is None else k_scale[b, :, k0:k1].float()
    vs = None if v_scale is None else v_scale[b, :, k0:k1].float()
    return kf, vf, ks, vs


def flash_split_reference(q, k, v, offsets, scale: float, softcap: float = 0.0,
                          sliding_window: int = 0, sinks=None, alibi_slopes=None,
                          k_scale=None, v_scale=None, n_sm: int = 132,
                          p_terms: int = 0) -> torch.Tensor:
    """The decode regime's plain version: per batch, the splits of
    `kv_splits` on `max_splits(B, Hkv, S, n_sm)`, each an f32 (m, l, acc)
    partial (a masked key adds 0; m starts at NEG_INF), merged in split
    order, then the sink column and safe l; output in q's dtype. p enters
    the PV product in f32 (p_terms 0: flash_decode_kernel), or rounded as
    `_round_p` rounds it (2: the latent form's decode). Each row's order is
    the same whatever R: the latent form's row groups split rows, not keys."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    n_max = max_splits(B, Hkv, S, n_sm)
    slopes = None if alibi_slopes is None else alibi_slopes.float()
    out = []
    for b in range(B):
        off = int(offsets[b])
        qf = q[b].float().reshape(T, Hkv, G, D)
        q_pos = off + torch.arange(T, device=q.device)
        parts = []
        for k0, k1 in kv_splits(off, T, S, sliding_window, n_max):
            kf, vf, ks, vs = _kv(k, v, k_scale, v_scale, b, k0, max(k0, k1))
            s = _masked_scores(qf, kf, ks, q_pos, torch.arange(k0, k0 + kf.shape[1],
                                                               device=q.device),
                               scale, softcap, sliding_window, slopes)
            m = torch.clamp(s.amax(-1), min=NEG_INF) if s.shape[-1] else \
                torch.full(s.shape[:-1], NEG_INF, device=q.device)
            p = torch.exp(s - m[..., None])
            pv = p if vs is None else p * vs[:, None, None, :]
            if p_terms:
                pv = _round_p(pv, p_terms)
            parts.append((m, p.sum(-1), torch.einsum("hgtn,hnd->hgtd", pv, vf)))
        m = parts[0][0]
        for pm, _, _ in parts[1:]:
            m = torch.maximum(m, pm)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(parts[0][2])
        for pm, pl, pa in parts:  # in split order
            w = torch.exp(pm - m)
            l = l + pl * w
            acc = acc + pa * w[..., None]
        out.append(_finish(m, l, acc, sinks, Hkv, G))
    return torch.stack(out).to(q.dtype)


def _round_p(p: torch.Tensor, terms: int) -> torch.Tensor:
    """p as the prefill kernel feeds it to the PV product: hi = bf16(p), and
    with two terms hi + bf16(p − hi)."""
    hi = p.to(torch.bfloat16).float()
    return hi if terms == 1 else hi + (p - hi).to(torch.bfloat16).float()


def flash_prefill_reference(q, k, v, offsets, scale: float, softcap: float = 0.0,
                            sliding_window: int = 0, sinks=None, alibi_slopes=None,
                            k_scale=None, v_scale=None, p_terms: int = 2) -> torch.Tensor:
    """The prefill regime's plain version: per block of PREFILL_ROWS query
    rows, the online softmax over PREFILL_TILE-key tiles from the block's
    window start, p (times the V scale in q8) rounded for the PV product as
    the kernel rounds it (p_terms 2: hi + lo bf16 terms; 1: one bf16 term),
    f32 sums; output in q's dtype."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    slopes = None if alibi_slopes is None else alibi_slopes.float()
    out = torch.empty((B, T, H, v.shape[-1]), dtype=torch.float32, device=q.device)
    for b in range(B):
        off = int(offsets[b])
        for t0 in range(0, T, PREFILL_ROWS):
            t1 = min(T, t0 + PREFILL_ROWS)
            qf = q[b, t0:t1].float().reshape(t1 - t0, Hkv, G, D)
            q_pos = off + torch.arange(t0, t1, device=q.device)
            k_begin = max(0, off + t0 - sliding_window + 1) if sliding_window > 0 else 0
            k_end = min(S, off + t1)
            m = torch.full((Hkv, G, t1 - t0), NEG_INF, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((Hkv, G, t1 - t0, v.shape[-1]), device=q.device)
            for kt in range(k_begin, k_end, PREFILL_TILE):
                k1 = min(k_end, kt + PREFILL_TILE)
                kf, vf, ks, vs = _kv(k, v, k_scale, v_scale, b, kt, k1)
                s = _masked_scores(qf, kf, ks, q_pos, torch.arange(kt, k1, device=q.device),
                                   scale, softcap, sliding_window, slopes)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                pv = p if vs is None else p * vs[:, None, None, :]
                acc = acc * corr[..., None] + torch.einsum("hgtn,hnd->hgtd",
                                                           _round_p(pv, p_terms), vf)
                m = m_new
            out[b, t0:t1] = _finish(m, l, acc, sinks, Hkv, G)
    return out.to(q.dtype)


def is_latent(k, v) -> bool:
    """Whether v is the first v.shape[-1] features of k's rows, a view of
    the same memory (the MLA latent: runtime/kvcache.py MLACache.kv)."""
    return (v.shape[-1] < k.shape[-1] and v.shape[:-1] == k.shape[:-1]
            and v.data_ptr() == k.data_ptr() and v.stride() == k.stride())


def takes(d: int, dv: int, latent: bool = False, dtype=torch.bfloat16) -> bool:
    """Whether the kernel takes query/key head dim d and value head dim dv:
    Dk = Dv in _HEAD_DIMS, (Dk, Dv) in DKDV_DIMS, or the latent form (v a
    view of k) at LATENT_DIMS on a bf16 cache."""
    if latent:
        return (d, dv) in LATENT_DIMS and dtype == torch.bfloat16
    return (d in _HEAD_DIMS and dv == d) or (d, dv) in DKDV_DIMS


def _check(q, kv, offsets, sinks, slopes):
    B, T, H, D = q.shape
    k, v = kv[0], kv[-1]
    if not takes(D, v.shape[-1]) or k.shape[0] != B or H % k.shape[1]:
        raise ValueError(f"flash: needs head_dim in {_HEAD_DIMS} (K and V alike) or (Dk, Dv) "
                         f"in {DKDV_DIMS}, H % Hkv == 0; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype != torch.bfloat16:
        raise ValueError("flash: q must be bf16")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (B,):
        raise ValueError("flash: offsets must be int32 [B]")
    for t in (q, *kv, offsets, sinks, slopes):
        if t is None:
            continue
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash: every operand must be on the same CUDA device")
        # Q, K and V rows are copied 16 bytes at a time, everything else by element
        align = 16 if t is q or t is k or t is v else t.element_size()
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError("flash: operands must be contiguous and aligned")
    for t in (sinks, slopes):
        if t is not None and (t.dtype != torch.float32 or t.numel() != H):
            raise ValueError("flash: sinks / ALiBi slopes must be f32 [H]")


def _check_latent(q, k, v, offsets, softcap, window, sinks, slopes):
    B, T, H, D = q.shape
    if not takes(D, v.shape[-1], True, k.dtype) or k.shape[0] != B or H % k.shape[1] \
            or k.shape[-1] != D:
        raise ValueError(f"flash: the latent form takes (Dk, Dv) in {LATENT_DIMS} on a bf16 "
                         f"cache; got q {tuple(q.shape)}, k {tuple(k.shape)} {k.dtype}, "
                         f"v {tuple(v.shape)}")
    if softcap or window or sinks is not None or slopes is not None:
        raise ValueError("flash: the latent form takes no softcap, window, sinks or ALiBi")
    if q.dtype != torch.bfloat16:
        raise ValueError("flash: q must be bf16")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (B,):
        raise ValueError("flash: offsets must be int32 [B]")
    for t in (q, k, offsets):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash: every operand must be on the same CUDA device")
        if not t.is_contiguous() or t.data_ptr() % (16 if t is not offsets else 4):
            raise ValueError("flash: operands must be contiguous and aligned")


def _library(d: int, dv: int) -> str:
    """The kernel library that instantiates head dims (d, dv)."""
    return "flash_dkdv" if d != dv else "flash_narrow" if d in NARROW_DIMS else "flash"


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _scratch(q, k, dv: int, latent: bool = False):
    """(output [B, T, H, dv], the stream, the decode regime's split count
    (0 in the prefill regime: the C entries take the prefill kernel then),
    its partials and counters: None where one split takes the keys, or in
    the prefill regime). A counter a (batch, KV head, row group of 16)."""
    B, T, H, _ = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    R = T * (H // Hkv)
    out = torch.empty((B, T, H, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_split, partial, counters = 0, None, None
    if regime(T, H, Hkv, latent) == "decode":
        n_split = max_splits(B, Hkv, S, _build.n_sm(q.device))
        if n_split > 1:
            partial = torch.empty(B * Hkv * n_split * R * (dv + 2), dtype=torch.float32,
                                  device=q.device)
            counters = _build.counters(q.device, stream, B * Hkv * -(-R // DECODE_ROWS))
    return out, stream, n_split, partial, counters


def _launch(fmt: str, fn, q, kv_ptrs, k, dv: int, offsets, scale, softcap, window, sinks,
            slopes):
    """One launch of the kernel of q's regime at value width dv; the decode
    regime's partials and the counters of the stream by which its last
    blocks find themselves."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out, stream, n_split, partial, counters = _scratch(q, k, dv)
    reg = regime(T, H, Hkv)
    rc = fn(q.data_ptr(), *kv_ptrs, offsets.data_ptr(), _ptr(sinks), _ptr(slopes),
            out.data_ptr(), _ptr(partial), _ptr(counters), B, T, H, Hkv, S, D, dv,
            float(scale), float(softcap), int(window), n_split, stream)
    _build.check(rc, f"flash {fmt} {dims_key(D, dv)} ({reg})")
    LAUNCHES[f"{fmt}.{dims_key(D, dv)}.{reg}"] += 1
    return out


def _launch_latent(q, k, dv: int, offsets, scale):
    """One launch of the latent form (v = k[..., :dv]) in q's regime."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out, stream, n_split, partial, counters = _scratch(q, k, dv, latent=True)
    reg = regime(T, H, Hkv, latent=True)
    fn = _build.bind("flash_latent", "tpullm_flash_latent_bf16", _LATENT_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), offsets.data_ptr(), out.data_ptr(), _ptr(partial),
            _ptr(counters), B, T, H, Hkv, S, D, dv, float(scale), n_split, stream)
    _build.check(rc, f"flash latent bf16 {dims_key(D, dv)} ({reg})")
    LAUNCHES[f"bf16.{dims_key(D, dv)}.{reg}"] += 1
    return out


def launch_total(fmt: str | None = None, regime: str | None = None, counts=None) -> int:
    """`counts` (LAUNCHES, or a delta of it) summed over the keys of one KV
    format and/or one regime ("decode", "prefill"); None takes every one."""
    return sum(n for key, n in (LAUNCHES if counts is None else counts).items()
               if fmt in (None, key.split(".")[0]) and regime in (None, key.split(".")[-1]))


def flash_attention(q, k, v, offsets, scale: float, softcap: float = 0.0,
                    sliding_window: int = 0, sinks=None, alibi_slopes=None):
    """Dense KV: q [B,T,H,Dk] bf16, k [B,Hkv,S,Dk] and v [B,Hkv,S,Dv] bf16,
    f16 or f32 (one dtype) → [B,T,H,Dv] bf16; or the latent form (v a view
    of k's first Dv features, `is_latent`) → [B,T,H,Dv]. The kernel of the call's regime
    and the cache's dtype on a CUDA tensor, the plain version on a CPU
    tensor."""
    if not q.is_cuda:
        return flash_reference(q, k, v, offsets, scale, softcap, sliding_window,
                               sinks, alibi_slopes)
    if is_latent(k, v):
        _check_latent(q, k, v, offsets, softcap, sliding_window, sinks, alibi_slopes)
        return _launch_latent(q, k, v.shape[-1], offsets, scale)
    _check(q, (k, v), offsets, sinks, alibi_slopes)
    fmt = DENSE_FORMATS.get(k.dtype)
    if fmt is None or v.dtype != k.dtype:
        raise ValueError(f"flash: the dense kernels take a bf16, f16 or f32 cache (K and V "
                         f"alike), got {k.dtype} / {v.dtype}")
    fn = _build.bind(_library(q.shape[-1], v.shape[-1]), f"tpullm_flash_{fmt}", _DENSE_ARGS)
    return _launch(fmt, fn, q, (k.data_ptr(), v.data_ptr()), k, v.shape[-1], offsets, scale,
                   softcap, sliding_window, sinks, alibi_slopes)


def flash_attention_q8(q, k_q, k_s, v_q, v_s, offsets, scale: float,
                       softcap: float = 0.0, sliding_window: int = 0, sinks=None,
                       alibi_slopes=None):
    """int8 KV with one f32 scale per position: k_q [B,Hkv,S,Dk] and v_q
    [B,Hkv,S,Dv] int8, k_s/v_s [B,Hkv,S] f32 → [B,T,H,Dv]."""
    if not q.is_cuda:
        return flash_reference(q, k_q, v_q, offsets, scale, softcap, sliding_window,
                               sinks, alibi_slopes, k_scale=k_s, v_scale=v_s)
    _check(q, (k_q, k_s, v_s, v_q), offsets, sinks, alibi_slopes)
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8 or \
            k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise ValueError("flash: the q8 kernel takes int8 codes and f32 scales")
    fn = _build.bind(_library(q.shape[-1], v_q.shape[-1]), "tpullm_flash_q8", _Q8_ARGS)
    return _launch("q8", fn, q, (k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr()),
                   k_q, v_q.shape[-1], offsets, scale, softcap, sliding_window, sinks,
                   alibi_slopes)
