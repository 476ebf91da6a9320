"""Mamba (S6) and Mamba-2 (SSD) decoders (the JAX package's models/mamba.py,
≡ llm_graph_context_mamba build_mamba_layer / build_mamba2_layer over
llama_memory_recurrent): archs `mamba` (alias `falcon-mamba`, its
weightless RMS on dt/B/C) and `mamba2` (its grouped RMS norm). The mixers
here are also the SSM layers of the hybrids (models/jamba.py).

A layer: RMSNorm → in-projection (qmm) → depthwise causal conv over the
cached d_conv − 1 tail → SiLU → the selective scan over the f32 state →
gate by SiLU(z) → out-projection (qmm), residual. The conv and the scan
are not Pallas kernels in the JAX package; here they are plain torch, on
the card too (a hand-written kernel is queued, ROADMAP.md §2b):

  * `causal_conv` is the k-tap shifted sum over [tail | x] (the JAX
    package's `_causal_conv`);
  * the scan h_t = a_t ⊙ h_{t−1} + b_t runs as a log-depth doubling scan
    (`doubling_scan`): round k = 1, 2, 4, … combines step t with step t − k,
    (a, b) ← (a_t a_{t−k}, a_t b_{t−k} + b_t), so a chunk of 512 tokens
    takes 9 rounds of elementwise work, never a loop over tokens; the JAX
    package runs the same combine as jax.lax.associative_scan. Mamba-2
    keeps its decay at the per-head shape [B, T, H] through the rounds,
    broadcast only inside each product. At T = 1 no round runs and the
    step is one multiply-add on the state, which the decode graphs
    capture.

States are f32 and written in place (runtime/recurrent.py), an idle slot's
rows kept (per-slot offsets −1). The forwards ignore positions: the state
carries them. Every token fed enters the state, so the engines run a
recurrent prompt at exact length (runtime/engine.py `recurrent_chunks`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFReader
from ..ops.norms import rms_norm
from ..runtime.recurrent import active_slots, conv_width
from .hparams import HParams
from .llama import Params, finish
from .weights import MODES, load_embedding, load_linear, load_vector


def first_name(t: dict, *names: str) -> str:
    """The first of `names` the file has (llama.cpp writes ssm_a and ssm_d
    with or without `.weight`)."""
    return next(n for n in names if n in t)


def ssm_params(t: dict, p: str, hp: HParams, linear, vector) -> dict:
    """The SSM entries of layer prefix `p`: mamba2 where the file has B/C
    groups (ssm.group_count, the JAX package's rule), A, D and dt_bias a
    head and the grouped norm where the file has it; else mamba1, with
    jamba's dt/B/C norms where the file has them. The conv kernel is f32
    [conv width, d_conv], A f32 (the file holds −exp(A_log), as the
    converter writes it)."""
    layer = {
        "ssm_in": linear(p + "ssm_in.weight"),
        "conv_w": vector(p + "ssm_conv1d.weight").reshape(conv_width(hp), hp.ssm_d_conv),
        "conv_b": vector(p + "ssm_conv1d.bias"),
        "dt_bias": vector(p + "ssm_dt.bias").reshape(-1),
        "D": vector(first_name(t, p + "ssm_d", p + "ssm_d.weight")).reshape(-1),
        "ssm_out": linear(p + "ssm_out.weight"),
    }
    a = vector(first_name(t, p + "ssm_a", p + "ssm_a.weight"))
    if not hp.ssm_n_group:  # mamba1
        layer.update({
            "ssm_x": linear(p + "ssm_x.weight"),
            "ssm_dt": linear(p + "ssm_dt.weight"),
            "A_log": a.reshape(hp.ssm_d_inner, hp.ssm_d_state),
            "dt_norm": vector(p + "ssm_dt_norm.weight"),
            "b_norm": vector(p + "ssm_b_norm.weight"),
            "c_norm": vector(p + "ssm_c_norm.weight"),
        })
    else:  # mamba2
        norm = vector(p + "ssm_norm.weight")
        layer.update({"A_log": a.reshape(-1),
                      "ssm_norm": None if norm is None else norm.reshape(-1)})
    return layer


def tensor_loaders(r: GGUFReader, device, dtype, mode: str):
    """(the file's tensors, linear(name), vector(name)): each loader None
    where the file lacks the tensor."""
    if mode not in MODES:
        raise ValueError(f"weight mode {mode!r} is not one of {MODES}")
    t = r.tensors

    def linear(name):
        return load_linear(t[name], device, dtype, mode) if name in t else None

    def vector(name):
        return load_vector(t[name], device) if name in t else None

    return t, linear, vector


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """A mamba or mamba2 file's weights onto `device`: packed planes for
    the quantized linears, f32 norms, conv kernels, A, D and dt biases, a
    dense embedding table; `output` None where the head is tied."""
    t, linear, vector = tensor_loaders(r, device, dtype, mode)
    layers = []
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        layers.append({"attn_norm": vector(p + "attn_norm.weight"),
                       **ssm_params(t, p, hp, linear, vector)})
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output": linear("output.weight"),
    }


def causal_conv(x: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in f32: x [B, T, D], the cached tail
    conv_state [B, D, K − 1], w [D, K], b [D] → (y [B, T, D], the new tail
    [B, D, K − 1]): the k-tap shifted sum over [tail | x]."""
    T, K = x.shape[1], w.shape[1]
    full = torch.cat([conv_state.float(), x.float().transpose(1, 2)], dim=2)  # [B, D, K−1+T]
    y = full[:, :, 0:T] * w[:, 0][None, :, None]
    for k in range(1, K):
        y = y + full[:, :, k:k + T] * w[:, k][None, :, None]
    y = y + b.float()[None, :, None]
    return y.transpose(1, 2).contiguous(), full[:, :, T:]


def doubling_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan of h_t = a_t ⊙ h_{t−1} + b_t over axis 1 (from
    h = 0): (the decay products a_1 ⊙ … ⊙ a_t, the states from zero), in
    ceil(log2 T) rounds. `a` broadcasts against `b` on the trailing axes
    (Mamba-2's [B, T, H, 1, 1] against [B, T, H, hd, S])."""
    T, k = b.shape[1], 1
    while k < T:
        b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], a[:, k:], b[:, :-k])], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def selective_scan(x, dt, A, Bm, Cm, h0) -> tuple[torch.Tensor, torch.Tensor]:
    """The S6 scan in f32: x, dt [B, T, D]; A [D, S]; Bm, Cm [B, T, S];
    h0 [B, D, S] → (y [B, T, D], the last state [B, D, S])."""
    a = torch.exp(dt[..., None] * A[None, None])  # [B, T, D, S]
    b = (dt * x)[..., None] * Bm[:, :, None, :]
    a, b = doubling_scan(a, b)
    h = torch.addcmul(b, a, h0[:, None])  # [B, T, D, S]
    return torch.einsum("btds,bts->btd", h, Cm), h[:, -1]


def ssd_scan(x, dt, A, Bm, Cm, h0, n_group: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 SSD scan in f32: x [B, T, H, hd]; dt [B, T, H]; A [H];
    Bm, Cm [B, T, G, S]; h0 [B, H, hd, S] → (y [B, T, H, hd], the last
    state). The decay stays [B, T, H] (one scalar a head and token)."""
    H = x.shape[2]
    Bh = torch.repeat_interleave(Bm, H // n_group, dim=2)  # [B, T, H, S]
    Ch = torch.repeat_interleave(Cm, H // n_group, dim=2)
    a = torch.exp(dt * A[None, None])[..., None, None]  # [B, T, H, 1, 1]
    b = (dt[..., None] * x)[..., None] * Bh[:, :, :, None, :]  # [B, T, H, hd, S]
    a, b = doubling_scan(a, b)
    h = torch.addcmul(b, a, h0[:, None])
    return torch.einsum("bthds,bths->bthd", h, Ch), h[:, -1]


def _weightless_rms(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v * torch.rsqrt((v * v).mean(-1, keepdim=True) + eps)


def mamba1_mixer(hp: HParams, layer: dict, h: torch.Tensor, conv0: torch.Tensor,
                 ssm0: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """A mamba1 layer's mixer on its normed input h [B, T, E] from the
    state (conv0, ssm0) → (out [B, T, E] in h's dtype, the new conv tail,
    the new state): jamba's dt/B/C RMS norms with weights where the layer
    has them, falcon-mamba's weightless ones under hp.ssm_dt_b_c_rms."""
    D, R, S = hp.ssm_d_inner, hp.ssm_dt_rank, hp.ssm_d_state
    xz = layer["ssm_in"](h).float()
    conv_out, conv_state = causal_conv(xz[..., :D], conv0, layer["conv_w"], layer["conv_b"])
    xc = F.silu(conv_out)
    x_db = layer["ssm_x"](xc.to(h.dtype)).float()
    dt_raw, Bm, Cm = x_db[..., :R], x_db[..., R:R + S], x_db[..., R + S:]
    if layer.get("dt_norm") is not None:
        dt_raw = rms_norm(dt_raw, layer["dt_norm"], hp.rms_eps)
        Bm = rms_norm(Bm, layer["b_norm"], hp.rms_eps)
        Cm = rms_norm(Cm, layer["c_norm"], hp.rms_eps)
    elif hp.ssm_dt_b_c_rms:
        dt_raw, Bm, Cm = (_weightless_rms(v, hp.rms_eps) for v in (dt_raw, Bm, Cm))
    dt = F.softplus(layer["ssm_dt"](dt_raw.to(h.dtype)).float() + layer["dt_bias"])
    y, ssm_state = selective_scan(xc, dt, layer["A_log"], Bm, Cm, ssm0)
    y = (y + xc * layer["D"][None, None]) * F.silu(xz[..., D:])
    return layer["ssm_out"](y.to(h.dtype)), conv_state, ssm_state


def mamba2_mixer(hp: HParams, layer: dict, h: torch.Tensor, conv0: torch.Tensor,
                 ssm0: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """A Mamba-2 SSD mixer over the fused z | xBC | dt projection (mamba2,
    and the SSM layers of nemotron_h, granitehybrid and falcon-h1): the
    conv over xBC, the scan, D, the SiLU(z) gate and the grouped RMS norm
    where the layer has one → (out [B, T, E], the new conv tail, the new
    state [B, d_inner, d_state])."""
    B, T = h.shape[:2]
    D, H, S, G = hp.ssm_d_inner, hp.ssm_dt_rank, hp.ssm_d_state, hp.ssm_n_group
    hd = D // H
    zxbcdt = layer["ssm_in"](h).float()
    conv_out, conv_state = causal_conv(zxbcdt[..., D:2 * D + 2 * G * S], conv0,
                                       layer["conv_w"], layer["conv_b"])
    xbc = F.silu(conv_out)
    xin = xbc[..., :D].reshape(B, T, H, hd)
    Bm = xbc[..., D:D + G * S].reshape(B, T, G, S)
    Cm = xbc[..., D + G * S:].reshape(B, T, G, S)
    dt = F.softplus(zxbcdt[..., 2 * D + 2 * G * S:] + layer["dt_bias"][None, None])
    y, ssm_state = ssd_scan(xin, dt, layer["A_log"], Bm, Cm, ssm0.reshape(B, H, hd, S), G)
    y = y + xin * layer["D"][None, None, :, None]
    y = y.reshape(B, T, D) * F.silu(zxbcdt[..., :D])
    if layer.get("ssm_norm") is not None:  # the grouped RMS norm
        yg = y.reshape(B, T, G, D // G)
        yg = yg / torch.sqrt((yg * yg).mean(-1, keepdim=True) + hp.rms_eps) \
            * layer["ssm_norm"].reshape(G, D // G)[None, None]
        y = yg.reshape(B, T, D)
    return layer["ssm_out"](y.to(h.dtype)), conv_state, ssm_state.reshape(B, D, S)


def mixer(hp: HParams, layer: dict):
    """The layer's SSM mixer: mamba1 where it has ssm_x, else mamba2."""
    return mamba1_mixer if layer.get("ssm_x") is not None else mamba2_mixer


def forward(hp: HParams, params: Params, tokens: torch.Tensor, positions: torch.Tensor,
            cache, cache_offset, last_index=None, return_hidden: bool = False):
    """tokens [B, T] → (logits f32, cache), as llama.forward returns them
    (last_index, return_hidden alike); mamba, falcon-mamba and mamba2 (the
    mixer chosen by the layer's tensors). `positions` is unused; the
    offset only marks idle slots (per-slot −1), whose state is kept."""
    x = params["tok_embd"][tokens]
    active = active_slots(cache_offset)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], hp.rms_eps)
        out, conv_state, ssm_state = mixer(hp, layer)(hp, layer, h, *cache.state(li))
        cache.write(li, conv_state, ssm_state, active)
        x = x + out
    return finish(hp, params, x, last_index, return_hidden), cache
