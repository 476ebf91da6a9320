"""Single-context inference engine: model load, bucketed prefill, decode loop
with sampling on the device, the host Sampler chain and embeddings.

The JAX package jits a prefill per bucket and a `lax.scan` decode chunk.
Here PyTorch runs the prefill eagerly, and the decode chunk runs on static
device buffers (runtime/graph.py `DecodeRunner`): on the card as replays of
a captured CUDA graph, on the CPU as the same step run eagerly. The sampled
token stays a device tensor and feeds the next step, so the host reads
token ids back once per chunk and never reads logits on that path.
`generate_tokens` is the JAX package's host loop instead: prefill, then
`decode_step`s whose logits go through a `Sampler` (penalties, grammars,
mirostat, ...). `decode_step` runs the logits-only step
(runtime/graph.py `LogitsRunner`: on the card a CUDA graph replayed a
step) and reads its logits back. Speculative verification
(runtime/speculative.py) feeds a few tokens at once through
`verify_logits` / `verify_ids` (runtime/graph.py `VerifyRunner`: one
forward at the prefill bucket, on the card a CUDA graph per bucket), and a
draft engine catches up through `feed`, on the same graphs.

The cache is written in place and never replaced by the engine's own
paths, so the runners' graphs stay valid across `reset`, prefills and
runtime/state.py's `load_state`; `new_cache` makes a new one and drops them.

A recurrent arch (registry `recurrent`: the SSMs and the hybrids) gets
its own cache (runtime/recurrent.py RecurrentCache, models/jamba.py
HybridCache), whose state absorbs every token fed: no path pads its
prompts. A prompt runs in chunks of the prefill cap, each cut by the JAX
package's ladder (512, 128, 32, 8, 1) (`recurrent_chunks`: 600 tokens run
as 512, 32, 32, 8, 8, 8), every chunk at its exact length; `reset` and
`new_cache` zero the state. Speculative verification is refused there (a
rejected draft would stay in the state: ROADMAP.md §3), and `feed` of
several tokens prefills them.

An iSWA model (registry `iswa`: gemma2, gemma3) gets the ring cache
(runtime/kvcache.py SWACache) as the JAX package gives it: a dense cache
dtype, a window, max_seq above it and no `swa_full`; its prefill then runs
in chunks of at most 1024 tokens, which the ring is sized for, and so does
a verification of more tokens than that (the JAX package verifies through
its chunked prefill_all_logits). Speculative rollback rewinds n_past on
the ring as on a full cache. An arch that brings its own cache (registry
`make_cache`: deepseek2's MLA latent) gets it.

The JAX Engine's options: `lora` (models/lora.py adapters wrapped around
the named linears at load, so the engine's q|k|v and gate|up stay
unfused), `control_vectors` (runtime vectors summed over their files into
params["cvec"], which the llama graph adds to each layer's residual
stream; other graphs ignore it, as the JAX package's do) and `grp_attn_n`
(self-extend: RoPE positions slot // grp_attn_n, the cache slots and the
causal mask unchanged). Under self-extend every path computes its
positions the same way: the eager prefill on the host, the decode, logits
and verify graphs on the device from their n_past buffers.

`prefill_embeddings` feeds input embeddings in place of token ids (the
llama graph's multimodal path: M-RoPE position streams, qwen3vl's
deepstack residuals), eagerly, in chunks of the prefill cap. `embed_tokens`
of a non-causal model (llama-embed) computes what the JAX package's
computes on a new engine, whatever ran before (see there).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models import llama
from ..ops.sampling_ops import SamplingParams, sample_token
from .graph import DecodeRunner, LogitsRunner, VerifyRunner
from .kvcache import SWACache, describe, make_cache, takes_ring
from .model import Model
from .sampling import Sampler, SamplerParams

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
PREFILL_CHUNK = 4096  # longer prompts prefill in chunks of this many tokens
# the JAX package's chunk ladder of a recurrent prefill (Engine._RECURRENT_CHUNKS)
RECURRENT_CHUNKS = (512, 128, 32, 8, 1)
SPEC_REFUSED = ("speculative decoding on a recurrent model is refused: its state absorbs a "
                "rejected draft, which no rewind of n_past takes back (ROADMAP.md §3, "
                "\"Speculation on recurrent state\")")


def recurrent_chunks(n: int, cap: int) -> list[int]:
    """The exact-length chunks of a recurrent prompt of n tokens: pieces
    of at most `cap`, each cut greedily by RECURRENT_CHUNKS, as the JAX
    Engine's prefill recursion cuts them."""
    out = []
    while n > 0:
        piece = min(n, cap)
        n -= piece
        while piece:
            c = next(c for c in RECURRENT_CHUNKS if c <= piece)
            out.append(c)
            piece -= c
    return out


def pool_hidden(h: np.ndarray, pooling: str, normalize: bool) -> np.ndarray:
    """One sequence's final-norm hidden states [n, E] pooled to [E] (mean |
    cls | last), L2-normalised with `normalize`."""
    if pooling == "mean":
        v = h.mean(axis=0)
    elif pooling == "cls":
        v = h[0]
    elif pooling == "last":
        v = h[-1]
    else:
        raise ValueError(f"unsupported pooling {pooling!r}")
    if normalize:
        v = v / max(np.linalg.norm(v), 1e-12)
    return v


@dataclass
class PerfCounters:
    t_load_s: float = 0.0
    t_prefill_s: float = 0.0
    n_prefill: int = 0
    t_decode_s: float = 0.0
    n_decode: int = 0

    def report(self) -> str:
        pp = self.n_prefill / self.t_prefill_s if self.t_prefill_s else 0.0
        tg = self.n_decode / self.t_decode_s if self.t_decode_s else 0.0
        return (f"load {self.t_load_s:.2f}s | prompt {self.n_prefill} tok "
                f"{pp:.1f} t/s | gen {self.n_decode} tok {tg:.1f} t/s")


class Engine:
    def __init__(self, model_path, *, device=None, mode: str = "auto",
                 dtype=torch.bfloat16, max_seq: int = 2048, kv_dtype=torch.bfloat16,
                 override_kv: dict | None = None, swa_full: bool = False,
                 lora: list | None = None, control_vectors: list | None = None,
                 grp_attn_n: int = 1):
        """`device=None` means CUDA (raises when there is none); the tests
        pass device="cpu". `mode` is the weight mode of build_params
        ("auto" and "quant": packed planes on the kernels; "dense": every
        linear dequantized to `dtype`, a plain product). `kv_dtype` is a
        torch dtype or a cache type: "f16", "bf16", "f32", "q8_0".
        `override_kv` updates the GGUF metadata before anything reads it
        (≡ --override-kv). `swa_full` keeps a full-size cache for the
        sliding-window layers of an iSWA model (≡ --swa-full).
        `model_path` may be a loaded `runtime/model.py` Model, whose weights
        the engine then shares (its load time is then the cache's).
        `lora` [(path, scale), ...] wraps the adapters' linears (unfused:
        on a shared Model one no plain engine has fused yet);
        `control_vectors` [(path, strength), ...] adds their sum to the
        residual stream of the llama graph; `grp_attn_n` > 1 is
        self-extend (RoPE positions slot // grp_attn_n)."""
        t0 = time.perf_counter()
        self.lora_info = [(str(p), float(s)) for p, s in lora or []]  # for /lora-adapters
        self.cvec_info = [(str(p), float(s)) for p, s in control_vectors or []]
        self.model = Model.of(model_path, device, mode, dtype, override_kv)
        self.device = self.model.device
        self.reader, self.hp, self.arch = self.model.reader, self.model.hp, self.model.arch
        self.tokenizer = self.model.tokenizer
        # the JAX rules: unfused under an adapter, and under control vectors
        # on a shared Model; fused (once, on the Model) otherwise
        shared = isinstance(model_path, Model)
        if self.lora_info or (self.cvec_info and shared):
            self.params = self.model.unfused_view()
        else:
            self.params = self.model.fused()
        self._adapt(dtype)
        self.grp_attn_n = max(1, int(grp_attn_n))
        self.max_seq = max_seq
        self.batch = 1
        self.kv_dtype, self.swa_full = kv_dtype, swa_full
        self.cache = self._make_cache()
        self.n_past = 0
        self._runners: dict = {}  # (SamplingParams, chunk) → DecodeRunner
        self._logits_runner: LogitsRunner | None = None
        self._verify_runners: dict[int, VerifyRunner] = {}  # rows → runner
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # load time includes the repack
        self.perf = PerfCounters(t_load_s=time.perf_counter() - t0)

    @torch.inference_mode()
    def _adapt(self, dtype) -> None:
        """The LoRA adapters wrapped around their linears (in the engine's
        copy of the tree's structure), and the control vectors summed into
        params["cvec"] [n_layer, n_embd] f32 of a shallow copy (the JAX
        Engine's load): the Model's own tree stays as it was."""
        from ..models.lora import apply_lora, load_lora_gguf
        from ..tools.cvector import load_control_vector

        for path, scale in self.lora_info:
            apply_lora(self.params, load_lora_gguf(path), scale, dtype=dtype)
        if self.cvec_info:
            total = sum(load_control_vector(path, self.hp.n_layer, strength)
                        for path, strength in self.cvec_info)
            self.params = {**self.params, "cvec": torch.from_numpy(
                np.asarray(total, np.float32)).to(self.device)}

    def _make_cache(self, prefill_cap: int | None = None):
        """The cache of `kv_dtype` and `swa_full`: the ring for an iSWA
        model on a dense dtype with a window below max_seq, sized for
        prefill chunks of `prefill_cap` (default 1024), else the full cache
        (chunks of PREFILL_CHUNK by default)."""
        self.ring = not self.swa_full and takes_ring(self.arch.iswa, self.hp, self.kv_dtype,
                                                     self.max_seq)
        self.prefill_cap = prefill_cap or min(self.max_seq, 1024 if self.ring else PREFILL_CHUNK)
        if self.ring:
            return SWACache.new(self.hp, self.batch, self.max_seq, self.kv_dtype,
                                max_chunk=self.prefill_cap, device=self.device)
        make = self.arch.make_cache or make_cache
        return make(self.hp, self.batch, self.max_seq, self.kv_dtype, self.device)

    def report(self) -> str:
        """The perf counters and the cache: its kind and dtype (an MLA
        latent's bf16 for a q8 request) and its bytes a position; the LoRA
        adapters, control vectors and self-extend group where the engine
        has them."""
        out = f"{self.perf.report()} | cache {describe(self.cache)}"
        for name, items in (("lora", self.lora_info), ("cvec", self.cvec_info)):
            if items:
                out += f" | {name} " + ", ".join(f"{p} ×{s:g}" for p, s in items)
        if self.grp_attn_n > 1:
            out += f" | self-extend grp_attn_n {self.grp_attn_n}"
        return out

    def rope_positions(self, slots: torch.Tensor) -> torch.Tensor:
        """The RoPE positions of cache slots (an int tensor, on the host or
        the device): slot // grp_attn_n under self-extend, else the slots.
        The graphs call it on their device n_past, so a replay computes the
        positions of its own step."""
        if self.grp_attn_n == 1:
            return slots
        return torch.div(slots, self.grp_attn_n, rounding_mode="floor")

    def reset(self):
        """n_past 0; on the ring every slot marked empty (in place), so that
        a new sequence attends no entry of the last one; a recurrent state
        zeroed (in place)."""
        self.n_past = 0
        if isinstance(self.cache, SWACache) or self.arch.recurrent:
            self.cache.reset_slots()

    def new_cache(self, kv_dtype=None, swa_full: bool | None = None):
        """A new, zeroed cache in place of the engine's, and n_past 0: of
        another `kv_dtype` or `swa_full` where given (the prefill cap that
        cache kind takes by default), else of the same kind at the current
        prefill cap (a ring is sized for it). The runners' graphs hold the
        old cache's buffers, so they are dropped (the next run captures
        anew)."""
        same = kv_dtype is None and swa_full is None
        if kv_dtype is not None:
            self.kv_dtype = kv_dtype
        if swa_full is not None:
            self.swa_full = swa_full
        self.cache = None  # the old cache's memory goes before the new one's
        self.cache = self._make_cache(self.prefill_cap if same else None)
        self._runners.clear()
        self._logits_runner = None
        self._verify_runners.clear()
        self.n_past = 0

    def _bucket(self, n: int) -> int:
        if self.arch.recurrent:  # pad tokens would enter the state
            return n
        for b in PREFILL_BUCKETS:
            if n <= b:
                return min(b, self.max_seq)
        raise ValueError(f"prompt of {n} tokens exceeds max bucket")

    def _positions(self, start: int, count: int) -> torch.Tensor:
        """[batch, count] RoPE positions of the cache slots from `start`."""
        pos = torch.arange(start, start + count, dtype=torch.int32, device=self.device)
        return self.rope_positions(pos)[None].expand(self.batch, count)

    def _padded(self, tokens: list[int]) -> torch.Tensor:
        """`tokens` as row 0 of a [batch, bucket] id tensor on the device."""
        toks = np.zeros((self.batch, self._bucket(len(tokens))), dtype=np.int64)
        toks[0, :len(tokens)] = tokens
        return torch.from_numpy(toks).to(self.device)

    @torch.inference_mode()
    def _prefill_logits(self, tokens: list[int]) -> torch.Tensor:
        """Run the prompt through the cache; logits of its last token [V]
        (f32, on the device)."""
        n = len(tokens)
        if self.n_past + n > self.max_seq:
            raise ValueError(f"context overflow: {self.n_past}+{n} > {self.max_seq}")
        if self.arch.recurrent:  # exact-length chunks, the last one's logits
            for c in recurrent_chunks(n, self.prefill_cap)[:-1]:
                self._prefill_logits(tokens[:c])
                tokens = tokens[c:]
            n = len(tokens)
        while n > self.prefill_cap:  # long prompts prefill in chunks
            self._prefill_logits(tokens[: self.prefill_cap])
            tokens = tokens[self.prefill_cap:]
            n = len(tokens)
        toks = self._padded(tokens)
        logits, self.cache = self.arch.forward(
            self.hp, self.params, toks, self._positions(self.n_past, toks.shape[1]), self.cache,
            self.n_past, last_index=n - 1)
        self.n_past += n
        return logits[0, 0]

    @torch.inference_mode()
    def _decode_logits(self, token: torch.Tensor) -> torch.Tensor:
        """One decode step on a device token tensor; next-token logits [V]."""
        if self.n_past >= self.max_seq:
            raise ValueError(f"context overflow: decode at n_past={self.n_past} >= "
                             f"max_seq={self.max_seq}")
        logits, self.cache = self.arch.forward(
            self.hp, self.params, token.reshape(1, 1).expand(self.batch, 1),
            self._positions(self.n_past, 1), self.cache, self.n_past)
        self.n_past += 1
        return logits[0, 0]

    @torch.inference_mode()
    def _prefill_embeddings(self, embds: np.ndarray, positions, deepstack) -> torch.Tensor:
        """prefill_embeddings' forwards; the logits of the last row [V]."""
        n = embds.shape[0]
        while n > self.prefill_cap:
            c = self.prefill_cap
            self._prefill_embeddings(embds[:c], None if positions is None else positions[:, :c],
                                     None if deepstack is None else deepstack[:, :c])
            embds = embds[c:]
            positions = None if positions is None else positions[:, c:]
            deepstack = None if deepstack is None else deepstack[:, c:]
            n = embds.shape[0]
        bucket = self._bucket(n)
        buf = torch.zeros((self.batch, bucket, embds.shape[1]), dtype=torch.float32)
        buf[0, :n] = torch.from_numpy(np.asarray(embds, np.float32))
        if positions is None:
            pos = self._positions(self.n_past, bucket)
        else:
            positions = np.asarray(positions, np.int32)
            pbuf = np.zeros((positions.shape[0], bucket), np.int32)
            pbuf[:, :n] = positions
            # pad rows continue past the last position (the JAX package's rule)
            pbuf[:, n:] = positions[:, -1:] + np.arange(1, bucket - n + 1, dtype=np.int32)
            pos = torch.from_numpy(pbuf).to(self.device)[:, None].expand(-1, self.batch, -1)
        ds = None
        if deepstack is not None:
            ds = torch.zeros((deepstack.shape[0], self.batch, bucket, embds.shape[1]),
                             dtype=torch.float32)
            ds[:, 0, :n] = torch.from_numpy(np.asarray(deepstack, np.float32))
            ds = ds.to(self.device)
        logits, self.cache = self.arch.forward(
            self.hp, self.params, buf.to(self.device), pos, self.cache, self.n_past,
            last_index=n - 1, deepstack=ds)
        self.n_past += n
        return logits[0, 0]

    def prefill_embeddings(self, embds: np.ndarray, positions: np.ndarray | None = None,
                           deepstack: np.ndarray | None = None) -> np.ndarray:
        """Feed input embeddings [n, n_embd] in place of token ids (the
        multimodal path, llama_batch.embd); returns the last position's
        logits [n_vocab]. `positions` [S, n]: one RoPE stream a M-RoPE
        section (qwen2vl, qwen3vl image grids); None: the positions of the
        cache slots. `deepstack` [n_ds, n, n_embd]: qwen3vl's visual
        residuals after layers 0 .. n_ds − 1, zero at text positions. The
        llama graph's option (the JAX package's Engine.prefill_embeddings),
        run eagerly in chunks of the prefill cap."""
        if self.arch.forward is not llama.forward:
            raise NotImplementedError(f"input embeddings run on the llama graph, not on "
                                      f"{self.hp.arch!r}'s")
        n = embds.shape[0]
        if self.n_past + n > self.max_seq:
            raise ValueError(f"context overflow: {self.n_past}+{n} > {self.max_seq}")
        t0 = time.perf_counter()
        out = self._prefill_embeddings(embds, positions, deepstack).cpu().numpy()
        self.perf.t_prefill_s += time.perf_counter() - t0
        self.perf.n_prefill += n
        return out

    def prefill(self, tokens: list[int]) -> np.ndarray:
        """Feed prompt tokens; returns logits of the last token [n_vocab]."""
        t0 = time.perf_counter()
        out = self._prefill_logits(list(tokens)).cpu().numpy()
        self.perf.t_prefill_s += time.perf_counter() - t0
        self.perf.n_prefill += len(tokens)
        return out

    def logits_runner(self) -> LogitsRunner:
        """The engine's logits-only decode step (its CUDA graph is captured
        at its first run and kept)."""
        if self._logits_runner is None:
            self._logits_runner = LogitsRunner(self)
        return self._logits_runner

    def decode_step(self, token: int) -> np.ndarray:
        """Feed one token; returns next-token logits [n_vocab] (a copy): one
        step of `logits_runner`, the numbers of the eager `_decode_logits`."""
        if self.n_past >= self.max_seq:
            raise ValueError(f"context overflow: decode at n_past={self.n_past} >= "
                             f"max_seq={self.max_seq}")
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits = self.logits_runner().run(int(token), self.n_past)
            out = logits.to("cpu", copy=True).numpy()
        self.n_past += 1
        self.perf.t_decode_s += time.perf_counter() - t0
        self.perf.n_decode += 1
        return out

    def verify_runner(self, rows: int) -> VerifyRunner:
        """The engine's verification forward of `rows` tokens (its CUDA
        graph is captured at its first run and kept). On the ring, rows up
        to the cache's `max_rows` (runtime/kvcache.py SWACache: a wider
        forward would overwrite slots its own queries see); the engine's
        verify takes at most prefill_cap rows a forward, which the ring is
        sized for."""
        if self.arch.recurrent:
            raise ValueError(SPEC_REFUSED)
        if isinstance(self.cache, SWACache) and rows > self.cache.max_rows:
            raise ValueError(f"a verify forward of {rows} rows on a ring of "
                             f"{self.cache.ring_len} slots (window {self.cache.window}) "
                             f"exceeds its {self.cache.max_rows} rows")
        runner = self._verify_runners.get(rows)
        if runner is None:
            runner = self._verify_runners[rows] = VerifyRunner(self, rows)
        return runner

    def _verify(self, tokens: list[int]) -> VerifyRunner:
        """`tokens` fed at n_past in one forward at their prefill bucket
        (one replay of `verify_runner`); n_past advances by len(tokens)."""
        n = len(tokens)
        if n == 0 or self.n_past + n > self.max_seq:
            raise ValueError(f"verify of {n} tokens at n_past={self.n_past} "
                             f"(max_seq {self.max_seq})")
        runner = self.verify_runner(self._bucket(n))
        with torch.inference_mode():
            runner.run(tokens, self.n_past)
        self.n_past += n
        return runner

    def verify_logits(self, tokens: list[int]) -> np.ndarray:
        """The logits of every position [T, n_vocab] of `tokens` fed at
        n_past (the numbers of prefill_all_logits, through the verify
        graph); only the T rows are read back. More tokens than the prefill
        cap go through prefill_all_logits in chunks of it, as the JAX
        package verifies."""
        n = len(tokens)
        if n > self.prefill_cap:
            return self.prefill_all_logits(tokens)
        return self._verify(tokens).logits[:n].to("cpu", copy=True).numpy()

    def verify_ids(self, tokens: list[int]) -> list[int]:
        """The argmax ids [T] of verify_logits, computed on the device: only
        the ids are read back (greedy acceptance)."""
        n = len(tokens)
        if n > self.prefill_cap:
            return torch.argmax(self.prefill_all_logits_device(tokens), dim=-1).tolist()
        return self._verify(tokens).ids[:n].tolist()

    def feed(self, tokens: list[int]) -> None:
        """Feed `tokens` into the cache at n_past, no logits read back (a
        draft engine catching up): one token through the logits graph, a
        few at once through the verify graph, a prompt's worth eagerly."""
        tokens = list(tokens)
        if len(tokens) == 1:
            if self.n_past >= self.max_seq:
                raise ValueError(f"context overflow: feed at n_past={self.n_past}")
            with torch.inference_mode():
                self.logits_runner().run(tokens[0], self.n_past)
            self.n_past += 1
        elif 1 < len(tokens) <= PREFILL_BUCKETS[1] and not self.arch.recurrent:
            self._verify(tokens)
        elif tokens:
            self._prefill_logits(tokens)

    def decode_runner(self, sp: SamplingParams, chunk: int) -> DecodeRunner:
        """The engine's decode runner for `sp` and `chunk` (its CUDA graphs
        are captured at its first run and kept for later calls)."""
        runner = self._runners.get((sp, chunk))
        if runner is None:
            runner = self._runners[(sp, chunk)] = DecodeRunner(self, sp, chunk)
        return runner

    def generate_tokens_device(self, prompt_tokens: list[int], max_new_tokens: int = 128,
                               temp: float = 0.0, top_k: int = 40, top_p: float = 0.95,
                               min_p: float = 0.05, seed: int = 0,
                               stop_on_eog: bool = True, chunk: int = 32,
                               to_end: bool = False) -> list[int]:
        """Generation with sampling on the device: each sampled id stays on
        the device and feeds the next step; ids are read back once per
        chunk of `chunk` steps (`decode_runner`: CUDA-graph replays on the
        card). Chunks run while a whole one fits below max_seq (the JAX
        package's rule); with `to_end` the steps after the last chunk run
        one at a time, each id read back, up to the step at n_past ==
        max_seq, as the JAX package's generate_tokens does."""
        sp = SamplingParams(temp, top_k, top_p, min_p)
        runner = self.decode_runner(sp, chunk)
        runner.gen.manual_seed(seed)
        vocab = self.tokenizer.vocab
        prompt_tokens = list(prompt_tokens)

        t0 = time.perf_counter()
        with torch.inference_mode():
            tok = sample_token(self._prefill_logits(prompt_tokens), runner.gen, sp)
            first = int(tok)  # sync point: the prefill has actually run
            runner.start(tok, self.n_past)
        self.perf.t_prefill_s += time.perf_counter() - t0
        self.perf.n_prefill += len(prompt_tokens)
        out: list[int] = []
        if stop_on_eog and vocab.is_eog(first):
            return out
        out.append(first)

        t0 = time.perf_counter()
        with torch.inference_mode():
            while len(out) < max_new_tokens and self.n_past + chunk < self.max_seq:
                ids = runner.run(chunk)
                self.n_past += chunk
                self.perf.n_decode += chunk
                done = False
                for t in ids:
                    if (stop_on_eog and vocab.is_eog(t)) or len(out) >= max_new_tokens:
                        done = True
                        break
                    out.append(t)
                if done or len(out) >= max_new_tokens:
                    break
            else:
                while to_end and len(out) < max_new_tokens and self.n_past < self.max_seq:
                    t = runner.run(1)[0]
                    self.n_past += 1
                    self.perf.n_decode += 1
                    if stop_on_eog and vocab.is_eog(t):
                        break
                    out.append(t)
        self.perf.t_decode_s += time.perf_counter() - t0
        return out

    def generate_tokens(self, prompt_tokens: list[int], max_new_tokens: int = 128,
                        sampler: Sampler | None = None, stop_on_eog: bool = True):
        """Yields generated token ids: prefill, then decode_step after
        decode_step, each row of logits through `sampler` on the host
        (greedy by default), up to the step at n_past == max_seq (the JAX
        package's generate_tokens)."""
        sampler = sampler or Sampler(SamplerParams(temp=0.0))
        logits = self.prefill(prompt_tokens)
        vocab = self.tokenizer.vocab
        for _ in range(max_new_tokens):
            token = sampler.sample(logits)
            sampler.accept(token)
            if stop_on_eog and vocab.is_eog(token):
                return
            yield token
            if self.n_past >= self.max_seq:
                return
            logits = self.decode_step(token)

    def generate(self, prompt: str, max_new_tokens: int = 128, sampler: Sampler | None = None,
                 add_special: bool = True, parse_special: bool = True) -> str:
        """Generation up to the context end, as the JAX package's generate
        runs: with a `sampler` through generate_tokens on the host, without
        one greedy through the device decode (the same ids as greedy
        generate_tokens)."""
        ids = self.tokenizer.tokenize(prompt, add_special=add_special,
                                      parse_special=parse_special)
        if sampler is None:
            out = self.generate_tokens_device(ids, max_new_tokens, temp=0.0, to_end=True)
        else:
            out = list(self.generate_tokens(ids, max_new_tokens, sampler))
        return self.tokenizer.detokenize(out)

    @torch.inference_mode()
    def prefill_all_logits_device(self, tokens: list[int]) -> torch.Tensor:
        """Like prefill, but the f32 logits of every position [T, n_vocab],
        left on the device (the perplexity tools reduce them there);
        prompts longer than the prefill cap in chunks."""
        n = len(tokens)
        if n > self.prefill_cap:
            return torch.cat([self.prefill_all_logits_device(tokens[i:i + self.prefill_cap])
                              for i in range(0, n, self.prefill_cap)], dim=0)
        if self.n_past + n > self.max_seq:
            raise ValueError(f"context overflow: {self.n_past}+{n} > {self.max_seq}")
        toks = self._padded(tokens)
        logits, self.cache = self.arch.forward(
            self.hp, self.params, toks, self._positions(self.n_past, toks.shape[1]), self.cache,
            self.n_past)
        self.n_past += n
        return logits[0, :n]

    def prefill_all_logits(self, tokens: list[int]) -> np.ndarray:
        """Like prefill, but the logits of every position [T, n_vocab] (the
        JAX package's prefill_all_logits)."""
        return self.prefill_all_logits_device(tokens).cpu().numpy()

    @torch.inference_mode()
    def embed_tokens(self, tokens: list[int], pooling: str | None = None,
                     normalize: bool = True) -> np.ndarray:
        """Pooled embedding vector [n_embd] of the final-norm hidden states
        (llama_get_embeddings_seq): pooling mean | cls | last (default the
        model's pooling_type, mean if unset), L2-normalised with
        `normalize`. A throwaway prefill at slot 0; n_past is 0 after (a
        recurrent state runs from zero and is zero after).

        A non-causal model (llama-embed): the JAX package runs its forward at
        cache offset n (the token count) and positions 0 .., so that the
        flash kernel's query row t sees slots [0, n + t]: the n slots before
        the tokens, then the tokens up to t. On a new engine those n slots
        are zero (keys of score 0 and values 0 in each row's softmax); the
        JAX package reads whatever earlier calls left there. Here they are
        zeroed first, so every call computes what the JAX package computes
        on a new engine, whatever ran before (llama.cpp's
        LLM_ARCH_LLAMA_EMBED attends without a mask over the batch's tokens;
        neither package computes that)."""
        pooling = pooling or (self.hp.pooling if self.hp.pooling != "none" else "mean")
        n = len(tokens)
        toks = self._padded(tokens)
        offset = 0
        if self.arch.recurrent:  # from a zero state, and zero after (n_past is 0)
            self.cache.reset_slots()
        if not self.hp.causal:
            if n + toks.shape[1] > self.max_seq:
                raise ValueError(f"a non-causal embedding of {n} tokens (bucket "
                                 f"{toks.shape[1]}) needs {n + toks.shape[1]} cache slots; "
                                 f"max_seq is {self.max_seq}")
            self.cache.clear_slots(n)
            offset = n
        pos = torch.arange(toks.shape[1], dtype=torch.int32, device=self.device)  # plain, as the JAX embed_tokens
        hidden, self.cache = self.arch.forward(
            self.hp, self.params, toks, pos[None].expand(self.batch, -1), self.cache, offset,
            return_hidden=True)
        self.n_past = 0  # the embedding pass does not advance generation state
        if self.arch.recurrent:
            self.cache.reset_slots()
        return pool_hidden(hidden[0, :len(tokens)].cpu().numpy(), pooling, normalize)

    def embed(self, text: str, pooling: str | None = None, normalize: bool = True) -> np.ndarray:
        ids = self.tokenizer.tokenize(text, add_special=True, parse_special=True)
        return self.embed_tokens(ids, pooling=pooling, normalize=normalize)
