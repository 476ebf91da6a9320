"""Mixture-of-experts routed FFN (the JAX package's ops/moe.py).

Two regimes, chosen on the token count of the call:
  * few tokens (decode, short prefill buckets): gather the k routed experts
    per token and run one expert-indexed matmul per projection, reading only
    the routed experts' packed bytes (the qmm_gather kernel on the card);
  * many tokens (prefill): every expert computes every token (the qmm_stack
    kernel on the card), and the routing weights, zero for the experts not
    chosen, combine them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# tokens per call (the padded bucket's B·T) at or below which the gather
# regime runs
_GATHER_MAX_TOKENS = 16


def route(router_logits: torch.Tensor, n_expert_used: int, gating: str = "softmax",
          norm_weights: bool = False, scale: float = 1.0,
          select_bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing: softmax (or sigmoid) → top-k → optional renorm.
    router_logits [N, n_expert] f32 → (weights [N, k] f32, idx [N, k] int32).

    select_bias ranks experts by probs + bias but weights them by the
    unbiased probs. Experts are ranked by a stable descending sort, so of
    equal probabilities the lower expert id comes first, as jax.lax.top_k
    orders them (torch.topk promises no order among ties)."""
    probs = torch.sigmoid(router_logits) if gating == "sigmoid" else \
        torch.softmax(router_logits, dim=-1)
    rank = probs if select_bias is None else probs + select_bias[None, :]
    idx = torch.sort(rank, dim=-1, descending=True, stable=True).indices[:, :n_expert_used]
    weights = torch.gather(probs, -1, idx)
    if norm_weights:
        weights = weights / weights.sum(-1, keepdim=True)
    if scale != 1.0:
        weights = weights * scale
    return weights, idx.to(torch.int32)


def route_sparsemixer(router_logits: torch.Tensor,
                      jitter_eps: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """PhiMoE's sparsemixer top-2 routing at inference (the JAX package's
    route_sparsemixer, in its f32 order): expert i is the argmax of the
    logits with the experts chosen before masked (the first index of a
    tie); its weight the softmax over the masked logits that lie within a
    2·jitter_eps relative band of their maximum, the band measured on the
    unmasked logits in both rounds. The two weights are not renormalised.
    router_logits [N, E] → (weights [N, 2] f32, idx [N, 2] int32), with no
    read-back to the host (a captured step holds it)."""
    s = router_logits.float()
    neg_inf = -1e30  # a Python number: no host-to-device copy in a captured step

    def one_round(scores):
        m = scores.max(dim=-1, keepdim=True).values
        sel = torch.argmax(scores, dim=-1)
        factor = torch.maximum(s.abs(), m)
        drop = ((m - s) / factor) > 2.0 * jitter_eps
        gates = torch.softmax(torch.where(drop, neg_inf, scores), dim=-1)
        return torch.gather(gates, -1, sel[:, None])[:, 0], sel

    w1, sel1 = one_round(s)
    s2 = torch.where(F.one_hot(sel1, s.shape[-1]).bool(), neg_inf, s)
    w2, sel2 = one_round(s2)
    return torch.stack([w1, w2], dim=-1), torch.stack([sel1, sel2], dim=-1).to(torch.int32)


def moe_ffn(x: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor, w_gate, w_up,
            w_down, act: str = "silu", weight_before_ffn: bool = False) -> torch.Tensor:
    """Gated (or gateless, w_gate None) expert FFN over x [N, n_embd],
    combining the k routed experts of each token. The expert weights are
    QuantExpertStacks or dense [E, n_in, n_out] tensors.

    weight_before_ffn scales the expert input by the routing weight (so the
    nonlinearity sees the scaled activations) instead of the output."""
    if x.shape[0] <= _GATHER_MAX_TOKENS:
        return _moe_gather(x, weights, idx, w_gate, w_up, w_down, act, weight_before_ffn)
    return _moe_dense(x, weights, idx, w_gate, w_up, w_down, act, weight_before_ffn)


def _glu(gate: torch.Tensor | None, up: torch.Tensor, act: str) -> torch.Tensor:
    if gate is None:  # gateless experts: the activation on up itself
        uf = up.float()
        if act == "relu_sqr":
            return torch.square(F.relu(uf)).to(up.dtype)
        if act == "gelu":
            return F.gelu(uf, approximate="tanh").to(up.dtype)
        return F.relu(uf).to(up.dtype)
    gf = gate.float()
    if act == "gelu":
        a = F.gelu(gf)
    elif act == "relu":
        a = F.relu(gf)
    else:
        a = F.silu(gf)
    return a.to(up.dtype) * up


def _is_packed(w) -> bool:
    from ..models.weights import QuantExpertStack

    return isinstance(w, QuantExpertStack)


def _stack_all(x: torch.Tensor, w) -> torch.Tensor:
    """All-experts matmul: x [M, K] (shared) or [E, M, K] → [E, M, F]."""
    if _is_packed(w):
        from . import qmatmul

        return qmatmul.stack_matmul(x, w)
    if x.dim() == 3:
        return torch.einsum("xne,xef->xnf", x, w)
    return torch.einsum("ne,xef->xnf", x, w)


def _rows_gather(x: torch.Tensor, ids: torch.Tensor, w) -> torch.Tensor:
    """Row t of x [T, K] through expert ids[t] → [T, F]."""
    if _is_packed(w):
        from . import qmatmul

        return qmatmul.gather_matmul(x, ids, w)
    return torch.einsum("tk,tkf->tf", x, w[ids.long()])


def _moe_gather(x, weights, idx, w_gate, w_up, w_down, act="silu",
                weight_before_ffn=False):
    N, k = idx.shape
    ids = idx.reshape(N * k)
    if weight_before_ffn:
        xk = (x[:, None, :] * weights[..., None].to(x.dtype)).reshape(N * k, -1)
    else:
        xk = x[:, None, :].expand(N, k, x.shape[-1]).reshape(N * k, -1)
    up = _rows_gather(xk, ids, w_up)
    gate = _rows_gather(xk, ids, w_gate) if w_gate is not None else None
    mid = _glu(gate, up, act)
    out = _rows_gather(mid, ids, w_down).reshape(N, k, -1)
    if weight_before_ffn:
        return out.float().sum(1).to(x.dtype)
    return torch.einsum("nke,nk->ne", out.float(), weights.float()).to(x.dtype)


def _moe_dense(x, weights, idx, w_gate, w_up, w_down, act="silu",
               weight_before_ffn=False):
    E = w_up.n_expert if _is_packed(w_up) else w_up.shape[0]
    onehot = F.one_hot(idx.long(), E).float()  # [N, k, E]
    dense_w = torch.einsum("nkx,nk->nx", onehot, weights.float())
    if weight_before_ffn:
        # per-(expert, token) scaled inputs: the nonlinearity sees w·x
        xs = x[None, :, :] * dense_w.T[:, :, None].to(x.dtype)  # [E, N, e]
        up = _stack_all(xs, w_up)
        gate = _stack_all(xs, w_gate) if w_gate is not None else None
        out = _stack_all(_glu(gate, up, act), w_down)  # [E, N, n_embd]
        sel = (dense_w.T != 0.0)[:, :, None]  # combine the selected experts only
        return torch.where(sel, out.float(), 0.0).sum(0).to(x.dtype)
    up = _stack_all(x, w_up)  # [E, N, F]
    gate = _stack_all(x, w_gate) if w_gate is not None else None
    out = _stack_all(_glu(gate, up, act), w_down)  # [E, N, n_embd]
    return torch.einsum("xne,nx->ne", out.float(), dense_w).to(x.dtype)
