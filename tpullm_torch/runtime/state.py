"""Context / sequence state serialization: the JAX package's
runtime/state.py (llama_state_* session files) for the port's Engine, in
the same npz format, so a file saved by either package restores in the
other.

A state file holds the live KV-cache prefix (row 0, positions [0, n_past))
as f32 (lossless from bf16 and f16; npz has no bf16 dtype), the token
history and the model's shape. Restore writes into the engine's cache in
place (`copy_` into its slices), never a new cache object: the engine's
captured decode graphs hold the cache's buffers (runtime/graph.py).

`save_slot_state` / `load_slot_state` do the same for one slot of a
BatchEngine (the server's slot save and restore), in the same format: the
slot's rows [0, n_past[slot]) in place of row 0's.

A q8 cache has no dense K/V to save (the JAX package's QuantKVCache has no
`.k` either) and raises a ValueError; iSWA and MLA state files wait for
those caches in the port.
"""

from __future__ import annotations

import numpy as np
import torch

MAGIC = "tpullm-state-v1"


def _meta(hp) -> dict:
    return {
        "arch": hp.arch,
        "n_layer": hp.n_layer,
        "n_head_kv": hp.n_head_kv,
        "head_dim": hp.head_dim,
        "head_dim_v": hp.head_dim_v,
    }


def _dense_cache(engine):
    cache = engine.cache
    if not hasattr(cache, "k"):
        raise ValueError(f"state files hold a dense KV cache (bf16, f16 or f32); this engine's "
                         f"is {type(cache).__name__} (kv_dtype {engine.kv_dtype!r})")
    return cache


def _save_row(engine, row: int, n: int, path, tokens):
    cache = _dense_cache(engine)
    k = cache.k[:, row, :, :n].float().cpu().numpy()  # [L, Hkv, n, Dk]
    v = cache.v[:, row, :, :n].float().cpu().numpy()
    np.savez_compressed(
        path, magic=MAGIC, n_past=n, k=k, v=v,
        tokens=np.asarray(tokens if tokens is not None else [], dtype=np.int64),
        **{f"meta_{key}": val for key, val in _meta(engine.hp).items()},
    )
    return path


def _load_row(engine, row: int, path) -> tuple[int, list[int]]:
    """The file's rows written into batch row `row` of the engine's cache,
    in place; (n_past, tokens)."""
    with np.load(path, allow_pickle=False) as z:
        _check(engine.hp, z)
        n = int(z["n_past"])
        if n > engine.max_seq:
            raise ValueError(f"saved state ({n} tokens) exceeds max_seq {engine.max_seq}")
        if "swa_k" in z.files or "mla_kvr" in z.files:
            raise ValueError("iSWA and MLA state files are not restored by the port yet")
        cache = _dense_cache(engine)
        if n:
            with torch.inference_mode():
                cache.k[:, row, :, :n].copy_(torch.from_numpy(z["k"]))
                cache.v[:, row, :, :n].copy_(torch.from_numpy(z["v"]))
        return n, [int(t) for t in z["tokens"]]


def save_state(engine, path, tokens: list[int] | None = None):
    """Save the engine's sequence state (batch row 0, n_past positions)."""
    return _save_row(engine, 0, int(engine.n_past), path, tokens)


def load_state(engine, path) -> list[int]:
    """Restore a saved sequence into the engine's cache, in place; returns
    the token prefix."""
    engine.n_past, tokens = _load_row(engine, 0, path)
    return tokens


def save_slot_state(bengine, slot: int, path, tokens: list[int] | None = None):
    """Save one slot of a BatchEngine (its n_past[slot] positions)."""
    return _save_row(bengine, slot, int(bengine.n_past[slot]), path, tokens)


def load_slot_state(bengine, slot: int, path) -> list[int]:
    """Restore a saved sequence into one slot of a BatchEngine, in place;
    returns the token prefix."""
    bengine.n_past[slot], tokens = _load_row(bengine, slot, path)
    return tokens


def _check(hp, z):
    if str(z["magic"]) != MAGIC:
        raise ValueError("not a tpullm state file")
    for key, val in _meta(hp).items():
        got = z[f"meta_{key}"]
        got = str(got) if key == "arch" else int(got)
        if got != val:
            raise ValueError(f"state/model mismatch on {key}: {got} != {val}")
