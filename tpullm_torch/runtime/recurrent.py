"""Recurrent state cache of the SSM models (the JAX package's
runtime/recurrent.py RecurrentCache, ≡ llama_memory_recurrent).

In place of K/V rows a position, each layer keeps a fixed-size state a
sequence: the last d_conv − 1 inputs of its depthwise causal conv and the
[d_inner, d_state] hidden state of its selective scan, both f32. The conv
width is d_inner for mamba1 and d_inner + 2·n_group·d_state for mamba2,
which convolves its concatenated x|B|C stream.

The state is written in place (`write`), as every cache of the port, so
the decode and logits graphs (runtime/graph.py) and the batched step stay
valid. A forward of a BatchEngine passes per-slot offsets with −1 for an
idle slot: `write` then keeps an idle slot's rows as they were, bit for
bit, by a select on the slot axis on the device (the JAX BatchEngine's
`keep_idle`), so nothing is read back to the host. `reset_slots` zeroes
one slot's state or all of them (a new sequence starts from zero).

The state absorbs every token fed: no path may pad a prompt (the engines
run exact-length chunks), and a rejected speculative draft cannot be
rolled back (ROADMAP.md §3: the engines refuse speculation on it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.hparams import HParams


def conv_width(hp: HParams) -> int:
    """The channels of the causal conv: mamba2 convolves x|B|C, mamba1 x."""
    if hp.ssm_n_group:
        return hp.ssm_d_inner + 2 * hp.ssm_n_group * hp.ssm_d_state
    return hp.ssm_d_inner


def active_slots(cache_offset) -> torch.Tensor | None:
    """The slots a forward writes: None for a host int or a 0-d device
    offset (every batch row: the single-stream Engine), else the bool [B]
    of per-slot offsets ≥ 0 (a BatchEngine step, −1 idle)."""
    if isinstance(cache_offset, torch.Tensor) and cache_offset.ndim == 1:
        return cache_offset >= 0
    return None


def write_state(arr: torch.Tensor, index: int, new: torch.Tensor,
                active: torch.Tensor | None) -> None:
    """arr[index] ← new [B, ...] in place; where `active` [B] is False the
    slot keeps its rows (a select on the device, no read-back)."""
    dst = arr[index]
    if active is None:
        dst.copy_(new)
        return
    keep = active.reshape((-1,) + (1,) * (new.ndim - 1))
    dst.copy_(torch.where(keep, new.to(dst.dtype), dst))


class StateRows:
    """The conv/ssm planes of a cache (`conv`, `ssm`: [n, B, ...] f32), a
    layer's plane at `state_index(layer)`: its state read, written in
    place (idle slots kept), zeroed and counted."""

    conv: torch.Tensor
    ssm: torch.Tensor

    def state_index(self, layer: int) -> int:
        return layer

    def state(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(conv [B, W, d_conv − 1], ssm [B, d_inner, d_state]) of a layer."""
        m = self.state_index(layer)
        return self.conv[m], self.ssm[m]

    def write(self, layer: int, conv_new: torch.Tensor, ssm_new: torch.Tensor,
              active: torch.Tensor | None = None) -> None:
        """A layer's new state, in place; idle slots (active False) kept."""
        m = self.state_index(layer)
        write_state(self.conv, m, conv_new, active)
        write_state(self.ssm, m, ssm_new, active)

    def reset_slots(self, slot: int | None = None) -> None:
        """Zero the state of one batch row, or of every row (in place)."""
        rows = slice(None) if slot is None else slice(slot, slot + 1)
        self.conv[:, rows].zero_()
        self.ssm[:, rows].zero_()

    def state_bytes(self) -> int:
        """The state's bytes for one sequence (every layer that has one)."""
        return self.conv[:, :1].nbytes + self.ssm[:, :1].nbytes


@dataclass
class RecurrentCache(StateRows):
    conv: torch.Tensor  # [L, B, conv width, d_conv − 1] f32
    ssm: torch.Tensor  # [L, B, d_inner, d_state] f32

    @classmethod
    def new(cls, hp: HParams, batch: int, max_len: int = 0, kv_dtype=None,
            device=None) -> "RecurrentCache":
        """Zero state for `batch` sequences (max_len and kv_dtype unused:
        the state has no positions and is always f32, as in the JAX
        package)."""
        return cls(torch.zeros((hp.n_layer, batch, conv_width(hp), hp.ssm_d_conv - 1),
                               dtype=torch.float32, device=device),
                   torch.zeros((hp.n_layer, batch, hp.ssm_d_inner, hp.ssm_d_state),
                               dtype=torch.float32, device=device))

    @property
    def max_len(self) -> int:  # the state has no length dimension
        return 1 << 30

    @property
    def batch(self) -> int:
        return self.conv.shape[1]

    def first_slots(self, n: int) -> "RecurrentCache":
        """A view of batch rows [0, n): its writes land in this cache."""
        return RecurrentCache(self.conv[:, :n], self.ssm[:, :n])

    def slot_view(self, slot: int) -> "RecurrentCache":
        """A view of batch row `slot` alone: its writes land in this cache."""
        return RecurrentCache(self.conv[:, slot:slot + 1], self.ssm[:, slot:slot + 1])
