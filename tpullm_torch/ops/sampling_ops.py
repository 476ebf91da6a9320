"""On-device sampling: greedy, temperature, top-k, top-p, min-p over a
fixed top-K extraction window, on a torch.Generator. Only token ids travel
back to the host.

The order is the JAX package's: top-k mask within the window, temperature
softmax, min-p, then top-p over the sorted window. The random stream is
torch's, not jax.random's, so sampled ids agree in distribution only;
greedy is bit-for-bit argmax, first index on ties. Nothing reads a value
back to the host, so a CUDA graph can capture the draw (its generator
registered with the graph).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

TOPK_WINDOW = 64  # fixed extraction width; top_k masks within it


@dataclass(frozen=True)
class SamplingParams:
    temp: float = 0.0  # <= 0 → greedy
    top_k: int = 40  # 0 → window-wide
    top_p: float = 0.95  # >= 1 → disabled
    min_p: float = 0.05  # 0 → disabled


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 p: SamplingParams) -> torch.Tensor:
    """logits [V] → sampled token id (0-d int64 tensor on logits' device)."""
    if p.temp <= 0.0:
        return torch.argmax(logits)
    window = min(TOPK_WINDOW, logits.shape[-1])
    vals, idx = torch.topk(logits.float(), window)  # descending
    k = min(p.top_k, window) if p.top_k > 0 else window
    ranks = torch.arange(window, device=logits.device)
    masked = torch.where(ranks < k, vals, torch.full_like(vals, float("-inf")))
    probs = torch.softmax(masked / max(p.temp, 1e-6), dim=-1)
    probs = torch.where(probs >= p.min_p * probs.max(), probs, torch.zeros_like(probs))
    norm = probs / probs.sum()
    keep = (torch.cumsum(norm, dim=-1) - norm) < p.top_p  # include the crossing element
    probs = torch.where(keep, probs, torch.zeros_like(probs))
    # torch.multinomial's one-sample draw (argmax of p / Exp(1) noise, the
    # same numbers from the same generator state) without its host-side
    # check of the distribution, which would read values back
    noise = torch.empty_like(probs).exponential_(1.0, generator=generator)
    # gather, not idx[t]: indexing by a 0-d tensor reads it back to the host
    return idx.gather(0, torch.argmax(probs / noise).reshape(1)).reshape(())
