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
mirostat, ...).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import tokenizer as tokenizer_mod
from ..device import resolve_device
from ..gguf.reader import GGUFReader
from ..models.registry import get_arch, load_hparams
from ..models.weights import fuse_llama_params
from ..ops.sampling_ops import SamplingParams, sample_token
from .graph import DecodeRunner
from .kvcache import make_cache
from .sampling import Sampler, SamplerParams

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
PREFILL_CHUNK = 4096  # longer prompts prefill in chunks of this many tokens


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
    def __init__(self, model_path, *, device=None, max_seq: int = 2048,
                 kv_dtype=torch.bfloat16):
        """`device=None` means CUDA (raises when there is none); the tests
        pass device="cpu". `kv_dtype` is a torch dtype or "q8_0"."""
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        self.reader = GGUFReader(model_path)
        self.hp = load_hparams(self.reader)
        self.arch = get_arch(self.hp.arch)
        self.tokenizer = tokenizer_mod.from_gguf(self.reader)
        with torch.inference_mode():
            params = self.arch.build_params(self.reader, self.hp, self.device)
            self.params = fuse_llama_params(params)
        self.max_seq = max_seq
        self.batch = 1
        self.prefill_cap = min(max_seq, PREFILL_CHUNK)
        self.cache = make_cache(self.hp, self.batch, max_seq, kv_dtype, self.device)
        self.n_past = 0
        self._runners: dict = {}  # (SamplingParams, chunk) → DecodeRunner
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # load time includes the repack
        self.perf = PerfCounters(t_load_s=time.perf_counter() - t0)

    def reset(self):
        self.n_past = 0

    def _bucket(self, n: int) -> int:
        for b in PREFILL_BUCKETS:
            if n <= b:
                return min(b, self.max_seq)
        raise ValueError(f"prompt of {n} tokens exceeds max bucket")

    def _positions(self, start: int, count: int) -> torch.Tensor:
        pos = torch.arange(start, start + count, dtype=torch.int32, device=self.device)
        return pos[None].expand(self.batch, count)

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

    def prefill(self, tokens: list[int]) -> np.ndarray:
        """Feed prompt tokens; returns logits of the last token [n_vocab]."""
        t0 = time.perf_counter()
        out = self._prefill_logits(list(tokens)).cpu().numpy()
        self.perf.t_prefill_s += time.perf_counter() - t0
        self.perf.n_prefill += len(tokens)
        return out

    def decode_step(self, token: int) -> np.ndarray:
        """Feed one token; returns next-token logits [n_vocab]."""
        t0 = time.perf_counter()
        tok = torch.full((1,), int(token), dtype=torch.int64, device=self.device)
        out = self._decode_logits(tok).cpu().numpy()
        self.perf.t_decode_s += time.perf_counter() - t0
        self.perf.n_decode += 1
        return out

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
    def prefill_all_logits(self, tokens: list[int]) -> np.ndarray:
        """Like prefill, but the logits of every position [T, n_vocab] (the
        perplexity path); prompts longer than the prefill cap in chunks."""
        n = len(tokens)
        if n > self.prefill_cap:
            return np.concatenate([self.prefill_all_logits(tokens[i:i + self.prefill_cap])
                                   for i in range(0, n, self.prefill_cap)], axis=0)
        if self.n_past + n > self.max_seq:
            raise ValueError(f"context overflow: {self.n_past}+{n} > {self.max_seq}")
        toks = self._padded(tokens)
        logits, self.cache = self.arch.forward(
            self.hp, self.params, toks, self._positions(self.n_past, toks.shape[1]), self.cache,
            self.n_past)
        self.n_past += n
        return logits[0, :n].cpu().numpy()

    @torch.inference_mode()
    def embed_tokens(self, tokens: list[int], pooling: str | None = None,
                     normalize: bool = True) -> np.ndarray:
        """Pooled embedding vector [n_embd] of the final-norm hidden states
        (llama_get_embeddings_seq): pooling mean | cls | last (default the
        model's pooling_type, mean if unset), L2-normalised with
        `normalize`. A throwaway prefill at slot 0; n_past is 0 after."""
        pooling = pooling or (self.hp.pooling if self.hp.pooling != "none" else "mean")
        toks = self._padded(tokens)
        hidden, self.cache = self.arch.forward(
            self.hp, self.params, toks, self._positions(0, toks.shape[1]), self.cache, 0,
            return_hidden=True)
        self.n_past = 0  # the embedding pass does not advance generation state
        h = hidden[0, :len(tokens)].cpu().numpy()  # [n, E] f32
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

    def embed(self, text: str, pooling: str | None = None, normalize: bool = True) -> np.ndarray:
        ids = self.tokenizer.tokenize(text, add_special=True, parse_special=True)
        return self.embed_tokens(ids, pooling=pooling, normalize=normalize)
