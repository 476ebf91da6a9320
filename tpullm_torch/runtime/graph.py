"""The decode chunk on static device buffers, captured as a CUDA graph.

The port's counterpart of the JAX package's `decode_chunk`
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

Launch counts: the kernel wrappers count in Python, so a capture adds to
their counts once and a replay adds nothing. The runner takes back what the
capture added and adds it again at every replay, so the counts hold the
launches that ran on the card.
"""

from __future__ import annotations

import time

import torch

from ..ops.sampling_ops import SamplingParams, sample_token


# the names of launch_counts()'s dicts, in order
COUNT_NAMES = ("qmm", "qmm_tc", "qmm_stack", "qmm_gather", "qmm_grouped", "dequant_routes",
               "flash", "flash_decode", "attn_dense_routes")


def launch_counts() -> tuple[dict, ...]:
    """Every launch and route count of the kernel wrappers (COUNT_NAMES)."""
    from ..ops.kernels import flash, qmm

    return (qmm.LAUNCHES, qmm.TC_LAUNCHES, qmm.STACK_LAUNCHES, qmm.GATHER_LAUNCHES,
            qmm.GROUPED_LAUNCHES, qmm.DEQUANT_ROUTES, flash.LAUNCHES, flash.DECODE_LAUNCHES,
            flash.ATTN_DENSE_ROUTES)


def _add_counts(delta: list[dict], sign: int = 1) -> None:
    for counts, d in zip(launch_counts(), delta):
        for k, v in d.items():
            counts[k] += sign * v


class DecodeRunner:
    """Decode steps of one engine under one SamplingParams, `chunk` at most
    a run, on static device buffers; on the card one step captured as a
    CUDA graph and replayed."""

    def __init__(self, engine, sp: SamplingParams, chunk: int):
        dev = engine.device
        self.engine, self.sp, self.chunk = engine, sp, chunk
        self.gen = torch.Generator(device=dev)
        self.token = torch.zeros(1, dtype=torch.int64, device=dev)
        self.n_past = torch.zeros(1, dtype=torch.int32, device=dev)
        self.step_index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.ids = torch.zeros(chunk, dtype=torch.int64, device=dev)
        self.cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if self.cuda else None
        self.graph = None
        self.replay_counts: list[dict] = []  # the launches one replay adds, per count dict
        self.capture_s: float | None = None
        self.pool_bytes: int | None = None  # the graph pool's reserved bytes
        self.replays = 0

    def start(self, token: torch.Tensor, n_past: int) -> None:
        """Load the buffers: the sampled `token` (a device id) goes in at
        cache slot `n_past`."""
        self.token.copy_(token.reshape(1))
        self.n_past.fill_(n_past)

    def step(self) -> None:
        """One decode step on the buffers (nothing read back to the host)."""
        e = self.engine
        logits, e.cache = e.arch.forward(e.hp, e.params, self.token.reshape(1, 1),
                                         self.n_past.reshape(1, 1), e.cache, self.n_past)
        tok = sample_token(logits[0, 0], self.gen, self.sp)
        self.ids.index_copy_(0, self.step_index, tok.reshape(1))
        self.token.copy_(tok.reshape(1))
        self.n_past.add_(1)
        self.step_index.add_(1)

    def _capture(self) -> None:
        """Capture one step as a graph on the runner's stream."""
        dev = self.engine.device
        before = [dict(c) for c in launch_counts()]
        g = torch.cuda.CUDAGraph()
        if self.sp.temp > 0.0:  # the draw's generator advances at every replay
            g.register_generator_state(self.gen)
        t0 = time.perf_counter()
        with torch.cuda.graph(g, stream=self.stream):
            reserved = torch.cuda.memory_reserved(dev)
            self.step()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.replay_counts = [{key: c[key] - b[key] for key in c if c[key] != b[key]}
                              for c, b in zip(launch_counts(), before)]
        _add_counts(self.replay_counts, -1)  # the capture launched nothing
        self.graph = g

    def launches_per_replay(self) -> dict[str, int]:
        """The launches one replay adds, summed over formats, by COUNT_NAMES."""
        return {name: sum(d.values()) for name, d in zip(COUNT_NAMES, self.replay_counts)}

    def run(self, n: int) -> list[int]:
        """`n` decode steps (at most `chunk`) from the buffers' state; their
        ids, read back once. On the card replays of the graph; the first
        run executes its first step eagerly, then captures."""
        if not 0 < n <= self.chunk:
            raise ValueError(f"a run takes 1 to {self.chunk} steps, not {n}")
        self.step_index.zero_()
        if not self.cuda:
            for _ in range(n):
                self.step()
            return self.ids[:n].tolist()
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
        return self.ids[:n].tolist()
