"""Decode steps on static device buffers, captured as CUDA graphs: the
decode chunk with sampling on the device, and the logits-only step.

`DecodeRunner` is the port's counterpart of the JAX package's `decode_chunk`
(tpullm/runtime/engine.py `_get_device_gen`: a jax.jit of a lax.scan over
decode steps). `DecodeRunner.step` is one decode step that reads and writes
only device buffers: it embeds the token of `token`, runs the forward at
the cache slot held in `n_past` (a device int32, which the cache write
takes as its index, RoPE as its position and the flash kernel as its
offsets), samples on the device, writes the id into `ids` at the device
step counter `step` and into `token` for the next step, and increments
`n_past` and `step`. No value comes back to the host inside it, so a CUDA
graph can hold it.

On the card a runner captures one step as a CUDA graph on its own stream
and replays it once a step; the host reads the ids once a run. Its first
run executes one step eagerly on that stream before the capture (a real
step of the generation: it loads the kernels' libraries, makes the
stream's split counters and the library handles, and computes RoPE's
inverse frequencies), then captures; a failed capture raises. On the CPU
the same step runs eagerly: the tests' path.

`LogitsRunner` is the same step without the sampling: it writes the f32
logits [V] of the token in `token` at the slot in `n_past` into `logits`,
and the host reads them (Engine.decode_step, the JAX package's jitted
`_step`: the host Sampler chain, perplexity-style scoring, the bench's tg
loop). The host sets `token` and `n_past` before each step, so the step
keeps no count of its own.

`VerifyRunner` is the speculative verification of a single-stream
Engine (the JAX package's jitted prefill of `prefill_all_logits` at a
bucket): `rows` tokens (a prefill bucket) fed at the cache offset held in
a device int32, through the per-slot offset path of the forward (the
cache write by gather/blend/scatter, so nothing is read back); it writes
the f32 logits [rows, V] and their argmax ids [rows]. The host loads the
tokens and the offset with one copy.

`BatchRunner` is one batched step of a BatchEngine
(runtime/batch_engine.py) over its first `width` slots, `rows` tokens a
slot: the width × rows rows of one forward at per-slot offsets, −1 for an
idle slot, read from static buffers (tokens, positions and offsets in one
int32 [2 rows + 1, width] buffer, so the host loads them with one copy),
against a view of those slots' cache rows; it writes the f32 logits
[width, rows, V] and their argmax ids [width, rows]. At one row a slot it
is the decode step (BatchEngine.decode_batch reads the logits back,
BatchEngine.decode_batch_greedy the ids); at `rows` > 1 the speculative
verification (BatchEngine.verify_batch: each slot's pending token and its
drafts, the rows past them padded). A step runs at the width of the
highest generating slot, so the rows computed follow the load. Its graph
is captured, and replayed, on the thread that calls it (the server's
scheduler thread).

The single-stream runners take their RoPE positions from the engine's
`rope_positions` of the device slot buffer (self-extend divides them by
`grp_attn_n` there, inside the graph), so a replay never reuses the
positions of the step it was captured at. On an iSWA ring the cache's
`advance` computes the ring rows from the same device offset, so a verify
replayed after a rollback writes the slots of the rewound positions.

On a recurrent arch (runtime/recurrent.py, models/jamba.py) the step's
state writes are in place too: the decode and logits runners write every
row's state, a BatchRunner's idle slots (offset −1) keep theirs through a
select on the device, and Engine.reset, a new prompt and
BatchEngine.free_slot zero or overwrite the same buffers, so the graphs
stay valid. A VerifyRunner is refused there (runtime/engine.py
SPEC_REFUSED: a rejected draft would stay in the state).

All follow one set of rules (`_CapturedStep`): the step reads and writes
only device buffers, the engine's parameters and its cache, which is
written in place (runtime/kvcache.py), so a captured graph stays valid
across Engine.reset, prefills and state loads; a path that replaces the
cache object drops the engine's runners (Engine.new_cache).

Launch counts: the kernel wrappers count in Python, so a capture adds to
their counts once and a replay adds nothing. A runner takes back what the
capture added and adds it again at every replay, so the counts hold the
launches that ran on the card.
"""

from __future__ import annotations

import gc
import time

import torch

from ..ops.sampling_ops import SamplingParams, sample_token


# the names of launch_counts()'s dicts, in order
COUNT_NAMES = ("qmm", "qmm_tc", "qmm_stack", "qmm_gather", "qmm_grouped", "dequant_routes",
               "flash", "attn_dense_routes", "attn_ring_routes")


def launch_counts() -> tuple[dict, ...]:
    """Every launch and route count of the kernel wrappers (COUNT_NAMES)."""
    from ..ops.kernels import flash, qmm

    return (qmm.LAUNCHES, qmm.TC_LAUNCHES, qmm.STACK_LAUNCHES, qmm.GATHER_LAUNCHES,
            qmm.GROUPED_LAUNCHES, qmm.DEQUANT_ROUTES, flash.LAUNCHES, flash.ATTN_DENSE_ROUTES,
            flash.ATTN_RING_ROUTES)


def count_summary(counts: list[dict]) -> dict:
    """Dicts in the order of launch_counts() (counts or deltas of them)
    summed by COUNT_NAMES, with flash's decode regime as "flash_decode"."""
    from ..ops.kernels import flash

    if not counts:  # a runner never captured (on the CPU) launched nothing
        return {}
    out = {name: sum(d.values()) for name, d in zip(COUNT_NAMES, counts)}
    flash_counts = counts[COUNT_NAMES.index("flash")]
    out["flash_decode"] = flash.launch_total(regime="decode", counts=flash_counts)
    return out


def _add_counts(delta: list[dict], sign: int = 1) -> None:
    for counts, d in zip(launch_counts(), delta):
        for k, v in d.items():
            counts[k] += sign * v


class _CapturedStep:
    """One step of `engine` on static device buffers (`step`, written by a
    subclass); on the card captured as a CUDA graph on the runner's own
    stream at its first run, after one eager step on that stream, and
    replayed once a step; on the CPU run eagerly. The capture's error mode
    is the thread's own, so a server's other threads are not drawn into
    it."""

    def __init__(self, engine):
        dev = engine.device
        self.engine = engine
        self.cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if self.cuda else None
        self.graph = None
        self.replay_counts: list[dict] = []  # the launches one replay adds, per count dict
        self.capture_s: float | None = None
        self.pool_bytes: int | None = None  # the graph pool's reserved bytes
        self.replays = 0

    def step(self) -> None:
        raise NotImplementedError

    def _register(self, graph) -> None:
        """Register the generators whose state the step advances."""

    def _capture(self) -> None:
        """Capture one step as a graph on the runner's stream, the cyclic
        garbage collector held off meanwhile: a dead engine's graph or
        stream (an engine and its runners form a cycle) destroyed
        mid-capture would invalidate the capture."""
        dev = self.engine.device
        before = [dict(c) for c in launch_counts()]
        g = torch.cuda.CUDAGraph()
        self._register(g)
        was_enabled = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(g, stream=self.stream, capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(dev)
                self.step()
        finally:
            if was_enabled:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.replay_counts = [{key: c[key] - b[key] for key in c if c[key] != b[key]}
                              for c, b in zip(launch_counts(), before)]
        _add_counts(self.replay_counts, -1)  # the capture launched nothing
        self.graph = g

    def launches_per_replay(self) -> dict[str, int]:
        """The launches one replay adds, summed over formats (count_summary)."""
        return count_summary(self.replay_counts)

    def _steps(self, n: int) -> None:
        """`n` steps from the buffers' state: on the card replays of the
        graph (the first run executes its first step eagerly, then
        captures), the current stream ordered after them; on the CPU the
        step run eagerly."""
        if not self.cuda:
            for _ in range(n):
                self.step()
            return
        current = torch.cuda.current_stream(self.engine.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            done = 0
            if self.graph is None:
                self.step()  # eagerly: it sets up the launches the graph holds
                done = 1
                self._capture()
            for _ in range(done, n):
                self.graph.replay()
                _add_counts(self.replay_counts)
                self.replays += 1
        current.wait_stream(self.stream)


class DecodeRunner(_CapturedStep):
    """Decode steps of one engine under one SamplingParams, `chunk` at most
    a run, on static device buffers; on the card one step captured as a
    CUDA graph and replayed."""

    def __init__(self, engine, sp: SamplingParams, chunk: int):
        super().__init__(engine)
        dev = engine.device
        self.sp, self.chunk = sp, chunk
        self.gen = torch.Generator(device=dev)
        self.token = torch.zeros(1, dtype=torch.int64, device=dev)
        self.n_past = torch.zeros(1, dtype=torch.int32, device=dev)
        self.step_index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.ids = torch.zeros(chunk, dtype=torch.int64, device=dev)

    def start(self, token: torch.Tensor, n_past: int) -> None:
        """Load the buffers: the sampled `token` (a device id) goes in at
        cache slot `n_past`."""
        self.token.copy_(token.reshape(1))
        self.n_past.fill_(n_past)

    def step(self) -> None:
        """One decode step on the buffers (nothing read back to the host)."""
        e = self.engine
        logits, e.cache = e.arch.forward(e.hp, e.params, self.token.reshape(1, 1),
                                         e.rope_positions(self.n_past).reshape(1, 1), e.cache,
                                         self.n_past.reshape(()))
        tok = sample_token(logits[0, 0], self.gen, self.sp)
        self.ids.index_copy_(0, self.step_index, tok.reshape(1))
        self.token.copy_(tok.reshape(1))
        self.n_past.add_(1)
        self.step_index.add_(1)

    def _register(self, graph) -> None:
        if self.sp.temp > 0.0:  # the draw's generator advances at every replay
            graph.register_generator_state(self.gen)

    def run(self, n: int) -> list[int]:
        """`n` decode steps (at most `chunk`) from the buffers' state; their
        ids, read back once. On the card replays of the graph; the first
        run executes its first step eagerly, then captures."""
        if not 0 < n <= self.chunk:
            raise ValueError(f"a run takes 1 to {self.chunk} steps, not {n}")
        self.step_index.zero_()
        self._steps(n)
        return self.ids[:n].tolist()


class LogitsRunner(_CapturedStep):
    """The logits of one decode step of one engine on static device buffers
    (token, n_past int32, f32 logits [V]); on the card one step captured as
    a CUDA graph and replayed, no sampling."""

    def __init__(self, engine):
        super().__init__(engine)
        dev = engine.device
        self.token = torch.zeros(1, dtype=torch.int64, device=dev)
        self.n_past = torch.zeros(1, dtype=torch.int32, device=dev)
        self.logits = torch.zeros(engine.hp.n_vocab, dtype=torch.float32, device=dev)

    def step(self) -> None:
        """One decode step on the buffers: the logits of `token` at cache
        slot `n_past` into `logits` (the cache row written)."""
        e = self.engine
        logits, e.cache = e.arch.forward(e.hp, e.params, self.token.reshape(1, 1),
                                         e.rope_positions(self.n_past).reshape(1, 1), e.cache,
                                         self.n_past.reshape(()))
        self.logits.copy_(logits[0, 0])

    def run(self, token: int, n_past: int) -> torch.Tensor:
        """The next-token logits [V] (the runner's buffer, valid until its
        next run) of `token` fed at cache slot `n_past`."""
        self.token.fill_(int(token))
        self.n_past.fill_(int(n_past))
        self._steps(1)
        return self.logits


class VerifyRunner(_CapturedStep):
    """One forward of `rows` tokens of a single-stream engine at the cache
    offset in `inputs[rows]`, on static device buffers (`inputs` int32
    [rows + 1]: the tokens, then the offset); it writes the f32 logits
    [rows, V] into `logits` and their argmax into `ids` (the first index
    on ties, as numpy's). On the card one forward captured as a CUDA graph
    and replayed."""

    def __init__(self, engine, rows: int):
        if engine.arch.recurrent:
            from .engine import SPEC_REFUSED

            raise ValueError(SPEC_REFUSED)
        super().__init__(engine)
        dev = engine.device
        self.rows = rows
        self.inputs = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
        self.arange = torch.arange(rows, dtype=torch.int32, device=dev)
        self.ids = torch.zeros(rows, dtype=torch.int64, device=dev)
        self.logits = torch.zeros(rows, engine.hp.n_vocab, dtype=torch.float32, device=dev)

    def step(self) -> None:
        """The forward of the buffers' tokens at their offset (nothing read
        back); its cache rows written in place."""
        e, T = self.engine, self.rows
        off = self.inputs[T:]
        logits, _ = e.arch.forward(e.hp, e.params, self.inputs[:T].long().reshape(1, T),
                                   e.rope_positions(off + self.arange).reshape(1, T), e.cache,
                                   off)
        self.logits.copy_(logits[0])
        self.ids.copy_(torch.argmax(self.logits, dim=-1))

    def run(self, tokens: list[int], n_past: int) -> None:
        """The forward of `tokens` (at most `rows`, the rest padded with id
        0) fed at cache slot `n_past`; the runner's `ids` and `logits` hold
        its output until its next run."""
        a = torch.zeros(self.rows + 1, dtype=torch.int32)
        a[:len(tokens)] = torch.tensor(tokens, dtype=torch.int32)
        a[self.rows] = n_past
        self.inputs.copy_(a)
        self._steps(1)


class BatchRunner(_CapturedStep):
    """One batched step of a BatchEngine's first `width` slots, `rows`
    tokens a slot, on static device buffers: `inputs` int32 [2 rows + 1,
    width] holds each slot's tokens (rows 0..rows−1), RoPE positions (the
    next `rows`) and cache offset (the last; −1: idle, its cache rows
    untouched); the step writes the f32 logits [width, rows, V] into
    `logits` and their argmax into `ids` [width, rows] (the first index on
    ties, as the JAX package's argmax), and the host reads back the ones it
    needs. On the card one step captured as a CUDA graph and replayed."""

    def __init__(self, engine, width: int, rows: int = 1):
        super().__init__(engine)
        dev = engine.device
        self.width, self.rows = width, rows
        self.inputs = torch.zeros(2 * rows + 1, width, dtype=torch.int32, device=dev)
        self.inputs[2 * rows].fill_(-1)
        self.ids = torch.zeros(width, rows, dtype=torch.int64, device=dev)
        self.logits = torch.zeros(width, rows, engine.hp.n_vocab, dtype=torch.float32,
                                  device=dev)

    def step(self) -> None:
        """One step of the slots on the buffers (nothing read back)."""
        e, B, T = self.engine, self.width, self.rows
        cache = e.cache if B == e.n_slots else e.cache.first_slots(B)
        tokens, positions = self.inputs[:T].t(), self.inputs[T:2 * T].t()
        logits, _ = e.arch.forward(e.hp, e.params, tokens.long(), positions.contiguous(),
                                   cache, self.inputs[2 * T])
        self.logits.copy_(logits)
        self.ids.copy_(torch.argmax(self.logits, dim=-1))

    def run(self, inputs: torch.Tensor) -> None:
        """One step from `inputs` (an int32 [2 rows + 1, width] host tensor:
        tokens, positions, offsets); the runner's `ids` and `logits`
        buffers hold its output until its next run."""
        self.inputs.copy_(inputs)
        self._steps(1)
