"""Continuous-batching scheduler (the JAX package's server/scheduler.py, on
the port's BatchEngine).

One thread owns the BatchEngine and every call into it: each iteration
admits queued requests into free slots (the slot whose cached tokens share
the longest prefix with the prompt), runs one joint prefill round for the
slots whose prompts are streaming in, then one batched decode step for
every generating slot. Results stream to per-request queues that the HTTP
layer reads. The engine's decode graphs are captured and replayed on this
thread only (torch's current stream is per thread); other threads hand it
work through queues (`embed`, and `_call`: slot save, restore and erase,
the graphs' capture at start-up) and never touch a CUDA tensor.

With speculation (`spec_type`: an n-gram speculator per slot, or `draft`
with a draft BatchEngine of the same slot layout) every generating slot
drafts up to `n_draft` tokens, and one verify step (BatchEngine.verify_step:
one graph replay of n_draft + 1 rows a slot) checks them all; each slot
keeps the longest prefix its sampler agrees with (exact match), so the
output is the plain scheduler's. Greedy slots read back the verified ids
only, sampled slots their own rows of logits.

On a recurrent engine (the SSMs and the hybrids), the JAX package's rules:
speculation is switched off (the state cannot take back a rejected draft)
and a recurrent draft engine is refused; a slot's prompt is prefilled at
once, at exact length (BatchEngine.prefill_slot), never in a joint padded
round; and a cached prefix is reused only where the new prompt extends
every token the slot's state absorbed (n_common == n_past), else the slot
starts from zero.
"""

from __future__ import annotations

import itertools
import queue
import re
import threading
import time
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from ..grammar import GrammarConstraint, LazyGrammarConstraint
from ..runtime.batch_engine import BatchEngine
from ..runtime.sampling import Sampler, SamplerParams, argmax_exact
from ..runtime.speculative import make_speculator
from ..runtime.state import load_slot_state, save_slot_state


class SlotState(Enum):
    IDLE = "idle"
    PREFILLING = "prefilling"  # prompt streaming in, one chunk per iteration
    GENERATING = "generating"


@dataclass
class GenRequest:
    prompt_ids: list[int]
    max_tokens: int = 128
    sampling: SamplerParams = field(default_factory=SamplerParams)
    stop: list[str] = field(default_factory=list)
    grammar: str | None = None  # GBNF text (set from grammar/json_schema params)
    # lazy-grammar triggers: [{"type": "word"|"pattern"|"token", "value": ...}];
    # non-empty → the grammar applies only once a trigger fires
    grammar_triggers: list = field(default_factory=list)
    n_probs: int = 0  # top-N logprobs per token (OpenAI logprobs)
    id: int = field(default_factory=itertools.count().__next__)
    # events: ("token", token_id, text[, probs]) | ("done", finish_reason, stats)
    out: queue.Queue = field(default_factory=queue.Queue)


@dataclass
class _Slot:
    index: int
    state: SlotState = SlotState.IDLE
    request: GenRequest | None = None
    sampler: Sampler | None = None
    n_generated: int = 0
    text: str = ""
    tokens: list = field(default_factory=list)  # prompt + generated ids
    pending_token: int | None = None
    prefill_tail: list | None = None  # prompt tokens not yet fed
    speculator: object = None  # per-slot draft proposer (ngram family)
    t_start: float = 0.0
    t_first_token: float = 0.0


class Scheduler:
    def __init__(self, engine: BatchEngine, *, spec_type: str | None = None,
                 draft_engine: BatchEngine | None = None, n_draft: int = 8,
                 cache_reuse: int = 0):
        self.engine = engine
        self.slots = [_Slot(i) for i in range(engine.n_slots)]
        self.pending: queue.Queue[GenRequest] = queue.Queue()
        self._jobs: queue.Queue = queue.Queue()  # (fn, args, result queue)
        self._embed_jobs: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        # in-scheduler speculative decoding (≡ server-context.cpp
        # can_speculate: every slot keeps decoding while drafted tokens are
        # verified in one batched forward of fixed shape)
        self.spec_type = spec_type
        self.draft_engine = draft_engine
        if spec_type == "draft" and draft_engine is None:
            raise ValueError("spec_type=draft requires a draft_engine")
        if draft_engine is not None and spec_type is None:
            self.spec_type = "draft"
        if engine.arch.recurrent and self.spec_type is not None:
            # the state absorbs every verified token and cannot roll back a
            # rejected draft: speculation is switched off (the JAX rule)
            self.spec_type = None
            self.draft_engine = None
        if self.draft_engine is not None and self.draft_engine.arch.recurrent:
            raise ValueError("a recurrent draft model cannot rewind; use a KV-cache draft "
                             "model (ROADMAP.md §3, \"Speculation on recurrent state\")")
        self.n_draft = max(1, n_draft)
        # --cache-reuse: min chunk length for mid-prompt KV reuse via
        # position shifting (0 = common-prefix reuse only)
        self.cache_reuse = cache_reuse if engine.can_shift else 0
        # metrics (≡ server_metrics)
        self.n_requests = 0
        self.n_tokens_generated = 0
        self.n_prompt_tokens = 0
        self.n_reused_tokens = 0
        self.n_context_shifts = 0
        self.n_spec_drafted = 0
        self.n_spec_accepted = 0
        self.n_keep = 4  # prompt tokens pinned across context shifts

    # -- public API ---------------------------------------------------------------

    def submit(self, req: GenRequest) -> GenRequest:
        self.n_requests += 1
        self.pending.put(req)
        self._wake.set()
        return req

    def _call(self, fn, *args, timeout: float = 300.0):
        """fn(*args) on the scheduler's thread when it runs (waiting up to
        `timeout` s for the result, an exception re-raised here), else on
        the caller's."""
        if self._thread is None or not self._thread.is_alive() or \
                threading.current_thread() is self._thread:
            return fn(*args)
        out: queue.Queue = queue.Queue()
        self._jobs.put((fn, args, out))
        self._wake.set()
        return self._result(out, timeout)

    @staticmethod
    def _result(out: queue.Queue, timeout: float):
        res = out.get(timeout=timeout)
        if isinstance(res, Exception):
            raise res
        return res

    def embed(self, tokens: list[int], pooling: str | None = None,
              timeout: float = 300.0) -> np.ndarray:
        """Blocking pooled-embedding call, run on the scheduler's thread in
        a free slot (≡ the server's embeddings over a borrowed slot)."""
        job = {"tokens": tokens, "pooling": pooling, "out": queue.Queue()}
        self._embed_jobs.put(job)
        self._wake.set()
        return self._result(job["out"], timeout)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True, name="tpullm-torch-sched")
        self._thread.start()

    def precompile(self, background: bool = True):
        """Captures the engine's decode graphs (and, with speculation, its
        verify graphs of n_draft + 1 rows, and the draft engine's graphs) on
        the scheduler's thread ahead of the first request (the JAX package
        compiles its programs here). With `background` it is queued and
        this returns at once."""
        def job():
            widths = (self.n_draft + 1,) if self.spec_type else ()
            self.engine.precompile(widths)
            if self.draft_engine is not None:
                self.draft_engine.precompile(widths)

        if background and self._thread is not None:
            self._jobs.put((job, (), queue.Queue()))
            self._wake.set()
            return None
        return self._call(job)

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=30)

    def slot_save(self, slot_id: int, path) -> dict:
        """≡ SERVER_TASK_TYPE_SLOT_SAVE."""
        def job():
            s = self.slots[slot_id]
            save_slot_state(self.engine, slot_id, path, tokens=s.tokens)
            return {"id_slot": slot_id, "n_saved": int(self.engine.n_past[slot_id])}
        return self._call(job)

    def slot_restore(self, slot_id: int, path) -> dict:
        def job():
            s = self.slots[slot_id]
            if s.state != SlotState.IDLE:
                raise ValueError(f"slot {slot_id} busy")
            s.tokens = load_slot_state(self.engine, slot_id, path)
            return {"id_slot": slot_id, "n_restored": int(self.engine.n_past[slot_id])}
        return self._call(job)

    def slot_erase(self, slot_id: int) -> dict:
        def job():
            s = self.slots[slot_id]
            if s.state != SlotState.IDLE:
                raise ValueError(f"slot {slot_id} busy")
            self.engine.free_slot(slot_id)
            if self.draft_engine is not None:
                self.draft_engine.free_slot(slot_id)
            s.tokens = []
            s.speculator = None
            return {"id_slot": slot_id, "n_erased": 1}
        return self._call(job)

    def slots_info(self) -> list[dict]:
        return [
            {
                "id": s.index,
                "state": s.state.value,
                "n_past": int(self.engine.n_past[s.index]),
                "n_generated": s.n_generated,
                "request_id": s.request.id if s.request else None,
            }
            for s in self.slots
        ]

    # -- loop -----------------------------------------------------------------------

    def _run(self):
        while not self._stop.is_set():
            did_work = self._run_jobs()
            did_work = self._iteration() or did_work
            if not did_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _run_jobs(self) -> bool:
        did = False
        while True:
            try:
                fn, args, out = self._jobs.get_nowait()
            except queue.Empty:
                return did
            try:
                out.put(fn(*args))
            except Exception as e:  # surface to the caller
                out.put(e)
            did = True

    def _free_slots(self):
        return [s for s in self.slots if s.state == SlotState.IDLE]

    @staticmethod
    def _common_prefix(a: list, b: list) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    def _iteration(self) -> bool:
        did = False
        # embedding jobs run in any idle slot, one per iteration
        free = self._free_slots()
        if free and not self._embed_jobs.empty():
            job = self._embed_jobs.get_nowait()
            try:
                job["out"].put(self.engine.embed_tokens(free[0].index, job["tokens"],
                                                        job["pooling"]))
            except Exception as e:  # surface to the caller
                job["out"].put(e)
            did = True
        # admit pending requests into free slots; their prompts then run
        # jointly, one batched round a chunk with per-slot offsets
        while free and not self.pending.empty():
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            # best-match slot by common prompt prefix (≡ the server's
            # launch_slot_with_task similarity selection)
            slot = max(free, key=lambda s: self._common_prefix(s.tokens, req.prompt_ids))
            free.remove(slot)
            did = True
            try:
                tail = self._prepare_admit(slot, req)
            except Exception as e:  # e.g. a grammar that does not parse: that request fails
                slot.request = slot.sampler = None
                req.out.put(("done", "error", {"error": f"{type(e).__name__}: {e}"}))
                tail = None
            if tail is None:
                # rejected without touching the slot's cache (context
                # overflow, a failed admission): give it back so later queue
                # entries can admit this pass
                free.append(slot)
            elif self.engine.arch.recurrent:
                # recurrent prefills run at once, at exact length
                logits = self.engine.prefill_slot(slot.index, tail)
                slot.state = SlotState.GENERATING
                self._advance(slot, logits, first=True)
            else:
                slot.prefill_tail = tail
                slot.state = SlotState.PREFILLING

        # ONE joint prefill round for the slots whose prompts stream in,
        # interleaved with the decode step below so generating slots keep
        # producing tokens during long admissions
        pre = {s.index: s for s in self.slots if s.state == SlotState.PREFILLING}
        if pre:
            chunk = {idx: s.prefill_tail[: self.engine.prefill_chunk] for idx, s in pre.items()}
            rows = self.engine.prefill_slots_round(chunk)
            for idx, s in pre.items():
                s.prefill_tail = s.prefill_tail[len(chunk[idx]):]
                if not s.prefill_tail:
                    s.prefill_tail = None
                    s.state = SlotState.GENERATING
                    self._advance(s, rows[idx], first=True)
            did = True

        # one batched decode step over generating slots
        gen = {
            s.index: s.pending_token
            for s in self.slots
            if s.state == SlotState.GENERATING and s.pending_token is not None
        }
        if gen:
            if self.spec_type:
                self._speculative_step(gen)
            else:
                self._decode(gen)
            did = True
        return did

    def _decode(self, gen: dict[int, int]):
        """One batched decode step for `gen` ({slot: pending token})."""
        if all(self._device_greedy_ok(self.slots[i]) for i in gen):
            # ids-only read-back: argmax on the device
            ids = self.engine.decode_batch_greedy(gen)
            for idx, tok in ids.items():
                self._advance_token(self.slots[idx], tok)
        else:
            logits = self.engine.decode_batch(gen)
            for idx, lg in logits.items():
                self._advance(self.slots[idx], lg)

    @staticmethod
    def _device_greedy_ok(slot: _Slot) -> bool:
        """Argmax on the device is exact iff no host-side logits transform
        can change the argmax (greedy temp, no penalties/DRY/bias, no
        grammar constraint: `argmax_exact`) and the request wants no
        logprobs."""
        return argmax_exact(slot.sampler) and slot.request.n_probs == 0

    # -- speculative decoding ---------------------------------------------------

    def _speculative_step(self, gen: dict[int, int]):
        """Draft + batched verify for every generating slot (≡ the
        reference's update_slots speculative branch). Slots with no draft
        this round ride the same verify step with a single token."""
        eng = self.engine
        width = self.n_draft + 1
        # stay clear of the context end: the verify write needs width cache
        # rows and the step after the accept one more
        can = {idx: pend for idx, pend in gen.items()
               if int(eng.n_past[idx]) + width + 1 < eng.max_seq}
        no_room = {idx: pend for idx, pend in gen.items() if idx not in can}
        drafts = self._propose(can) if can else {}
        if not any(drafts.values()):
            self._decode(gen)
            return
        # draft-less slots with room ride the same verify step (its shape is
        # fixed: a one-token row costs nothing extra)
        seqs = {idx: [gen[idx]] + drafts.get(idx, [])[: width - 1] for idx in can}
        r = eng.verify_step(seqs, width)
        greedy = {idx for idx in seqs if self._device_greedy_ok(self.slots[idx])}
        ids = r.ids.tolist() if greedy else None
        rows = {idx: r.logits[idx].to("cpu", copy=True).numpy()
                for idx in seqs if idx not in greedy}  # a sampled slot's own rows
        for idx, fed in seqs.items():
            if idx in greedy:
                self._accept(self.slots[idx], fed, ids=ids[idx])
            else:
                self._accept(self.slots[idx], fed, logits_rows=rows[idx])
        if no_room:  # rare: the last `width` tokens before a context shift
            self._decode(no_room)

    def _propose(self, gen: dict[int, int]) -> dict[int, list[int]]:
        if self.spec_type == "draft":
            return self._propose_draft(gen)
        out = {}
        for idx, pend in gen.items():
            slot = self.slots[idx]
            if slot.speculator is None:
                slot.speculator = make_speculator(self.spec_type, n_draft=self.n_draft)
            # slot.tokens ends with the pending token = the speculator
            # contract's "ctx ending in the next token to feed"
            slot.speculator.resync(slot.tokens)
            out[idx] = slot.speculator.propose(pend, self.n_draft)
        return out

    def _propose_draft(self, gen: dict[int, int]) -> dict[int, list[int]]:
        """Batched greedy draft continuation on the draft model: n_draft
        batched steps serve every speculating slot at once, the argmax on
        the device. A slot's draft cache is first brought to its context
        but the pending token: rewound, or fed the few tokens it misses
        together with the pending token in one verify step (whose ids at
        the pending token's row are the first drafts), or, for a prompt's
        worth, in joint prefill rounds."""
        d = self.draft_engine
        rows = self.n_draft + 1
        tails, long = {}, {}
        for idx in gen:
            toks = self.slots[idx].tokens
            want = len(toks) - 1  # the draft cache holds ctx[:-1]
            have = int(d.n_past[idx])
            if have > want:
                d.rewind(idx, want)
                have = want
            tail = toks[have:want]
            if len(tail) >= rows:
                long[idx] = tail
            elif tail:
                tails[idx] = tail
        if long:
            d.prefill_slots(long)
        drafts = {idx: [] for idx in gen}
        cur = dict(gen)
        first = None
        if tails and all(int(d.n_past[i]) + rows <= d.max_seq for i in gen):
            seqs = {i: tails.get(i, []) + [cur[i]] for i in gen}
            ids = d.verify_batch_greedy(seqs, rows)
            first = {i: ids[i][len(seqs[i]) - 1] for i in gen}
            for i, seq in seqs.items():
                d.n_past[i] += len(seq)
        elif tails:
            d.prefill_slots(tails)
        for step in range(self.n_draft):
            if step == 0 and first is not None:
                out = first
            else:
                if any(int(d.n_past[i]) + 1 >= d.max_seq for i in cur):
                    break
                out = d.decode_batch_greedy(cur)
            for idx, t in out.items():
                drafts[idx].append(t)
                cur[idx] = t
        return drafts

    def _accept(self, slot: _Slot, fed: list[int], logits_rows=None, ids=None):
        """Longest-matching-prefix acceptance over one slot's verify rows
        (their logits, or for a greedy slot their argmax ids). fed[0] is the
        committed pending token; fed[1:] are drafts. Row j holds the
        distribution after fed[:j+1]."""
        eng, idx = self.engine, slot.index
        old = int(eng.n_past[idx])
        n_drafted = len(fed) - 1
        n_accepted = 0
        n_valid = 0
        for j in range(len(fed)):
            n_valid = j + 1
            if ids is not None:
                self._advance_token(slot, ids[j], spec=True)
            else:
                self._advance(slot, logits_rows[j], spec=True)
            if slot.state != SlotState.GENERATING:
                break
            if j + 1 < len(fed) and slot.pending_token == fed[j + 1]:
                n_accepted += 1
                continue
            break
        eng.n_past[idx] = old + n_valid
        self.n_spec_drafted += n_drafted
        self.n_spec_accepted += n_accepted
        if slot.speculator is not None and hasattr(slot.speculator, "accept"):
            slot.speculator.accept(n_accepted)
        # the context-shift check deferred from the accept loop (n_past was
        # not yet committed there)
        if (slot.state == SlotState.GENERATING
                and int(eng.n_past[idx]) + 1 >= eng.max_seq):
            self._context_shift(slot)

    def _prepare_admit(self, slot: _Slot, req: GenRequest) -> list[int] | None:
        """Slot bookkeeping for a new request up to (not including) the
        prompt prefill. Returns the token tail still to prefill, or None
        when the request was answered here (context overflow)."""
        eng = self.engine
        n = len(req.prompt_ids)
        if n >= eng.max_seq:
            req.out.put(("done", "context_overflow", {}))
            return None
        slot.request = req
        if req.grammar:
            if req.grammar_triggers:
                patterns, tok_ids = [], []
                for trig in req.grammar_triggers:
                    kind = trig.get("type", "word")
                    val = trig.get("value", "")
                    if kind == "token":
                        tok_ids.append(int(val))
                    elif kind == "word":
                        # a WORD trigger is a start-anchored floating
                        # pattern with the word as its capture group
                        patterns.append(r"[\s\S]*?(" + re.escape(val) + ")")
                    else:  # "pattern" / "pattern_full"
                        patterns.append(str(val))
                constraint = LazyGrammarConstraint.from_tokenizer(
                    req.grammar, eng.tokenizer,
                    trigger_patterns=patterns, trigger_tokens=tok_ids,
                )
            else:
                constraint = GrammarConstraint.from_tokenizer(req.grammar, eng.tokenizer)
            slot.sampler = Sampler(req.sampling, constraint_fn=constraint,
                                   constraint_accept=constraint.accept)
        else:
            slot.sampler = Sampler(req.sampling)
        slot.n_generated = 0
        slot.text = ""
        slot.t_start = time.perf_counter()
        # prompt-cache reuse (≡ cache_prompt): keep the matching cache prefix
        # and prefill only the new tail; at least one token is fed again so
        # that the last position's logits exist. The cache holds KV only up
        # to n_past (the last sampled token of a finished request was never
        # decoded back in).
        n_common = min(self._common_prefix(slot.tokens, req.prompt_ids), n - 1,
                       int(eng.n_past[slot.index]))
        if eng.arch.recurrent and n_common != int(eng.n_past[slot.index]):
            # the state holds every absorbed token: reused only where the new
            # prompt extends all of them, never cut back to a shorter prefix
            n_common = 0
        n_valid = n_common
        if n_common > 0 and self.cache_reuse > 0:
            n_valid = self._cache_reuse_shift(slot, req.prompt_ids, n_common)
        if not eng.ring_holds(slot.index, n_valid):
            n_valid = 0  # the ring no longer holds the window before it
        if n_valid > 0:
            eng.n_past[slot.index] = n_valid
            tail = req.prompt_ids[n_valid:]
            self.n_reused_tokens += n_valid
        else:
            eng.free_slot(slot.index)
            tail = req.prompt_ids
        # speculative state belongs to the previous request; the draft cache
        # keeps only the prefix that still matches the new prompt
        slot.speculator = None
        if self.draft_engine is not None:
            d = self.draft_engine
            d.rewind(slot.index, min(int(d.n_past[slot.index]), n_common))
        slot.tokens = list(req.prompt_ids)
        self.n_prompt_tokens += n
        return tail

    def _cache_reuse_shift(self, slot: _Slot, prompt: list[int], n_common: int) -> int:
        """Mid-prompt KV reuse by hole punching (≡ server --cache-reuse):
        past the common prefix, cached chunks of ≥ cache_reuse tokens that
        reappear later in the new prompt are moved left (K re-rotated by
        the position delta) instead of computed again. Returns the new count
        of valid cache rows."""
        eng, idx_slot = self.engine, slot.index
        old = slot.tokens
        n_cache = min(len(old), int(eng.n_past[idx_slot]))
        n = len(prompt)
        S = eng.max_seq
        idx = np.arange(S, dtype=np.int32)
        delta = np.zeros(S, dtype=np.int32)
        head_c = head_p = n_common
        moved = False
        while head_c < n_cache and head_p < n - 1:
            n_match = 0
            while (head_c + n_match < n_cache and head_p + n_match < n
                   and old[head_c + n_match] == prompt[head_p + n_match]):
                n_match += 1
            if n_match >= self.cache_reuse:
                # at least the final prompt token must be fed again for logits
                used = min(n_match, n - 1 - head_p)
                idx[head_p:head_p + used] = np.arange(head_c, head_c + used)
                delta[head_p:head_p + used] = head_p - head_c
                moved = moved or head_p != head_c
                head_c += used
                head_p += used
            else:
                head_c += 1
        if moved:
            eng.shift_slot(idx_slot, idx, delta)
        return head_p

    def _advance(self, slot: _Slot, logits: np.ndarray, first: bool = False,
                 spec: bool = False):
        token = slot.sampler.sample(logits)
        self._advance_token(slot, token, logits=logits, first=first, spec=spec)

    def _advance_token(self, slot: _Slot, token: int, logits: np.ndarray | None = None,
                       first: bool = False, spec: bool = False):
        """Bookkeeping after one sampled token; `logits` is None on the
        device-greedy path (taken only when n_probs == 0). Inside a
        speculative accept run (`spec`) n_past is not yet committed, so the
        context-shift check waits for `_accept`."""
        req = slot.request
        slot.sampler.accept(token)
        vocab = self.engine.tokenizer.vocab
        if first:
            slot.t_first_token = time.perf_counter()

        if vocab.is_eog(token):
            self._finish(slot, "stop")
            return
        piece = self.engine.tokenizer.detokenize([token])
        slot.text += piece
        slot.tokens.append(token)
        slot.n_generated += 1
        self.n_tokens_generated += 1
        if req.n_probs > 0:
            lp = logits - np.log(np.exp(logits - logits.max()).sum()) - logits.max()
            top = np.argsort(-lp)[: req.n_probs]
            probs = [
                {"id": int(t), "logprob": float(lp[t]),
                 "token": self.engine.tokenizer.detokenize([int(t)])}
                for t in top
            ]
            req.out.put(("token", token, piece, {"logprob": float(lp[token]), "top": probs}))
        else:
            req.out.put(("token", token, piece))

        for stop in req.stop:
            if stop and stop in slot.text:
                self._finish(slot, "stop")
                return
        if slot.n_generated >= req.max_tokens:
            self._finish(slot, "length")
            return
        if not spec and int(self.engine.n_past[slot.index]) + 1 >= self.engine.max_seq:
            self._context_shift(slot)
        slot.pending_token = token

    def _context_shift(self, slot: _Slot):
        """StreamingLLM-style shift (≡ the server's context shift): keep
        n_keep head tokens and the recent half of the window, and prefill
        the compressed history again."""
        eng = self.engine
        keep = self.n_keep
        half = (eng.max_seq - keep) // 2
        kept = slot.tokens[:keep] + slot.tokens[-half:]
        eng.free_slot(slot.index)
        # the token just sampled (last of `kept`) goes in through
        # pending_token at the next decode step; prefilling it here too
        # would write it into the cache twice
        eng.prefill_slot(slot.index, kept[:-1])
        slot.tokens = list(kept)
        # the draft cache no longer matches the compressed history; ngram
        # speculators realign through their prefix-safe resync
        if self.draft_engine is not None:
            self.draft_engine.free_slot(slot.index)
        self.n_context_shifts += 1
        self._wake.set()

    def _finish(self, slot: _Slot, reason: str):
        req = slot.request
        now = time.perf_counter()
        stats = {
            "prompt_n": len(req.prompt_ids),
            "predicted_n": slot.n_generated,
            "ttft_ms": round((slot.t_first_token - slot.t_start) * 1e3, 2),
            "total_ms": round((now - slot.t_start) * 1e3, 2),
        }
        req.out.put(("done", reason, stats))
        slot.state = SlotState.IDLE
        slot.request = None
        slot.sampler = None
        slot.pending_token = None
        # slot.tokens and the KV prefix stay for prompt-cache reuse
        self._wake.set()
