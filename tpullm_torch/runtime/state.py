"""Context / sequence state serialization: the JAX package's
runtime/state.py (llama_state_* session files) for the port's Engine, in
the same npz format, so a file saved by either package restores in the
other.

A state file holds the live KV-cache prefix (row 0, positions [0, n_past))
as f32 (lossless from bf16 and f16; npz has no bf16 dtype), the token
history and the model's shape, stored uncompressed (np.savez: deflating
a Gemma-3-4B ring's 0.5 GB of rows took a minute; the JAX package deflates,
and np.load reads either). Restore writes into the engine's cache in
place (`copy_` into its slices), never a new cache object: the engine's
captured decode graphs hold the cache's buffers (runtime/graph.py).

`save_slot_state` / `load_slot_state` do the same for one slot of a
BatchEngine (the server's slot save and restore), in the same format: the
slot's rows [0, n_past[slot]) in place of row 0's.

An iSWA ring cache (runtime/kvcache.py SWACache) saves as the JAX package
saves it: the full-attention layers' rows [0, n_past) as `k`/`v`, and the
whole ring of the row (`swa_k`, `swa_v`), its slot positions (`slot_pos`)
and its window (`swa_window`); a restore checks the window and the ring's
length against the engine's. A ring file restores only into a ring engine
and a full file only into a full one.

An MLA latent cache (runtime/kvcache.py MLACache) saves as the JAX package
saves it: the latent plane's rows [0, n_past) as `k` [L, 1, n, kvr + n_rot],
an empty `v`, and the latent's width as `mla_kvr`; it restores only into an
MLACache engine of that width, and a file of another cache not into one.

A q8 cache has no dense K/V to save (the JAX package's QuantKVCache has no
`.k` either) and raises a ValueError.

A recurrent model's cache (runtime/recurrent.py RecurrentCache,
models/jamba.py HybridCache) is refused with a ValueError, both ways: the
JAX package's format keeps no conv/ssm state (its RecurrentCache has no
`k` and raises; its HybridCache saves the K/V alone), and restoring half a
state would continue a sequence from the wrong one (ROADMAP.md §3).
"""

from __future__ import annotations

import numpy as np
import torch

from .kvcache import MLACache, SWACache

MAGIC = "tpullm-state-v1"
STATE_REFUSED = ("state files hold no recurrent state: a recurrent model's cache is refused "
                 "rather than saved or restored in half (ROADMAP.md §3, \"State files of "
                 "recurrent models\")")


def _meta(hp) -> dict:
    return {
        "arch": hp.arch,
        "n_layer": hp.n_layer,
        "n_head_kv": hp.n_head_kv,
        "head_dim": hp.head_dim,
        "head_dim_v": hp.head_dim_v,
    }


def _dense_cache(engine):
    """The engine's cache as (k, v) [L, B, Hkv, S, D] of the layers the
    file's `k`/`v` hold (a ring cache: its full-attention layers)."""
    cache = engine.cache
    if engine.arch.recurrent:
        raise ValueError(f"{STATE_REFUSED} ({type(cache).__name__})")
    if isinstance(cache, SWACache):
        return cache.full_k, cache.full_v
    if isinstance(cache, MLACache):  # the latent is the state; no V plane
        return cache.c, None
    if not hasattr(cache, "k"):
        raise ValueError(f"state files hold a dense KV cache (bf16, f16 or f32); this engine's "
                         f"is {type(cache).__name__} (kv_dtype {engine.kv_dtype!r})")
    return cache.k, cache.v


def _save_row(engine, row: int, n: int, path, tokens):
    ck, cv = _dense_cache(engine)
    k = ck[:, row, :, :n].float().cpu().numpy()  # [L, Hkv, n, Dk]
    v = cv[:, row, :, :n].float().cpu().numpy() if cv is not None else \
        np.zeros((0,), dtype=np.float32)
    extra = {}
    cache = engine.cache
    if isinstance(cache, MLACache):
        extra = dict(mla_kvr=cache.kvr)
    if isinstance(cache, SWACache):
        extra = dict(swa_k=cache.swa_k[:, row].float().cpu().numpy(),
                     swa_v=cache.swa_v[:, row].float().cpu().numpy(),
                     slot_pos=cache.slot_pos[row].cpu().numpy(), swa_window=cache.window)
    np.savez(
        path, magic=MAGIC, n_past=n, k=k, v=v,
        tokens=np.asarray(tokens if tokens is not None else [], dtype=np.int64),
        **{f"meta_{key}": val for key, val in _meta(engine.hp).items()},
        **extra,
    )
    return path


def _load_row(engine, row: int, path) -> tuple[int, list[int]]:
    """The file's rows written into batch row `row` of the engine's cache,
    in place; (n_past, tokens)."""
    ck, cv = _dense_cache(engine)
    with np.load(path, allow_pickle=False) as z:
        _check(engine.hp, z)
        n = int(z["n_past"])
        if n > engine.max_seq:
            raise ValueError(f"saved state ({n} tokens) exceeds max_seq {engine.max_seq}")
        cache = engine.cache
        if ("mla_kvr" in z.files) != isinstance(cache, MLACache) or (
                "mla_kvr" in z.files and int(z["mla_kvr"]) != cache.kvr):
            raise ValueError("an MLA state file restores into an MLACache engine of its "
                             "latent width, and another file not into one")
        ring = isinstance(cache, SWACache)
        if ("swa_k" in z.files) != ring:
            raise ValueError("an iSWA state file restores into an iSWA ring engine, and a "
                             "full-cache file into a full-cache one")
        if ring and (int(z["swa_window"]) != cache.window
                     or z["swa_k"].shape[2] != cache.ring_len):
            raise ValueError("iSWA state geometry mismatch (window/ring)")
        with torch.inference_mode():
            if n:
                ck[:, row, :, :n].copy_(torch.from_numpy(z["k"]))
                if cv is not None:
                    cv[:, row, :, :n].copy_(torch.from_numpy(z["v"]))
            if ring:
                cache.swa_k[:, row].copy_(torch.from_numpy(z["swa_k"]))
                cache.swa_v[:, row].copy_(torch.from_numpy(z["swa_v"]))
                cache.slot_pos[row].copy_(torch.from_numpy(z["slot_pos"].astype(np.int32)))
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
