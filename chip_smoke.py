#!/usr/bin/env python3
"""Smoke run of tpullm_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits nonzero:
 1. card: name and power limit (nvidia-smi), torch and CUDA versions;
    whether the `regex` module imports there (for information: the port
    does not use it);
 2. build: compiles every kernel library from tpullm_torch/csrc with nvcc,
    one process per library (the qmm sources once per layout family), and
    prints each library's compile seconds, the `-Xptxas -v` report, and
    each tensor-core kernel's registers and spill bytes;
 3. kernels vs plain: each kernel against its plain PyTorch version on the
    card at the shapes of the main paths (qmm: all 22 formats at the 8B
    gate_up and down, M in {1, 8, 16, 512}: M = 1 and 8 on CUDA cores, 16
    and 512 on the tensor cores, M = 1 also timed cold, rotating among
    copies of the planes that together exceed the 50 MB L2, and at M = 512
    the CUDA-core kernel timed on the same planes; Q4_K and Q6_K also at
    the other Llama-3-8B shapes and Q5_K and Q8_0 at Mixtral's attention
    shapes, M = 1; qmm_grouped, the
    group-factored kernel: all 22 formats at the 8B gate_up and down, M
    in {1, 8, 16, 128, 512} (below 16 rows on the gemv body, from 16 on
    the grouped form of the tensor-core body, K split at down), timed
    beside qmm (qmm_tc from 16 rows) on the same planes; qmm_stack and qmm_gather: all 22
    formats as expert stacks at Mixtral's 4096→14336 and 14336→4096, stack
    M = 512 with a shared x (and, for Q4_K and Q6_K, a per-expert x), gather
    T in {2, 32} and T = 32 with every slot on one expert, and ids outside
    the stack giving NaN rows; flash: bf16 and q8 KV, T in {1, 512}, S = 4096, GQA 32/8
    (T = 1 the split-KV decode regime, T = 512 the tensor-core prefill
    regime, each also against the plain version of its own order, and the
    prefill's p rounding, one bf16 term and two, measured on its plain
    version), plus small softcap / window / sink / ALiBi cases), held to the NMSE
    bounds of the JAX package's conformance sweep; each timed with CUDA
    events over a CUDA graph of back-to-back calls (device time, not the
    Python wrapper's dispatch) beside its bound and a PyTorch library call;
 4. tiny: the tiny dense model at every dense preset and the tiny MoE at
    Q4_K_M, MXFP4_MOE and IQ2_XXS, served on the card against the CPU; and
    generate_tokens through a GBNF grammar and a penalised host Sampler on
    the card against the CPU;
 5. slice: a Llama-3-8B Q4_K_M GGUF synthesized from a seed with Llama-3's
    byte-level BPE vocab (tokenizer.ggml.model "gpt2", pre "llama-bpe"),
    a fixed mixed-script sentence through its tokenizer and back, then the
    model served by Engine with a bf16 and with a q8 KV cache: three
    prompts (one of 512 tokens), 64 generated tokens each (the decode
    chunk as CUDA-graph replays), one prompt twice for determinism; load
    time and its peak memory, TTFT, pp512 and decode tok/s, peak memory,
    device time by kernel family of one profiled chunk of decode steps (the
    graph's replays) and of one profiled 512-token prefill, each kernel's
    launches against the count expected per forward; and the graph phase
    (`graph_decode`):
    greedy ids of the graph against a decode_step loop over two chunks and
    a tail, launches per replay, capture seconds and pool bytes, decode
    wall, busy and idle a token with the graph beside eager steps, and two
    sampled runs from one seed;
 6. presets: Llama-3-8B served the same way with 4 layers, one prompt and
    16 decode steps each, at Q2_K (bf16 and q8 KV), IQ4_XS, Q4_0, Q4_1,
    Q5_0, Q5_1, IQ4_NL and Q3_K_M; then Mixtral-8x7B at
    MXFP4_MOE with 4 layers (a 64-token prompt through qmm_stack, decode
    through qmm_gather);
 7. i-quants: Llama-3-8B at IQ1_S and IQ3_XXS at full depth; at IQ2_XXS,
    IQ2_XS, IQ2_M, IQ1_M, IQ3_M, TQ1_0 and TQ2_0 with 4 layers; Mixtral-8x7B
    at IQ2_XXS with 4 layers; the 8B at Q4_K_M with 4 layers and Q4_K and
    Q6_K in qmm.GROUPED_TYPES, every 2-D launch through qmm_grouped, and a
    profiled 512-token prefill whose every 2-D launch of the layers ran
    qmm_grouped_tc_kernel;
 8. mixtral: a Mixtral-8x7B Q4_K_M GGUF (≈28 GB, the 8-expert recipe)
    synthesized from a seed and served the same way with a bf16 KV cache,
    with the graph phase;
 9. routes: the tiny model with a 250-token head on the card against the
    CPU, its head through the counted dequantize-then-matmul route, and one
    attention call at head dim 96 through the counted dense path;
10. the card line, the `kernels` JSON line, and the result line.

Every serving run checks its launches per regime: each forward's 2-D qmm
on the tensor cores from 16 rows (the prefill buckets of 16 and up, the
head aside: it runs on the last row only) and on CUDA cores below, the
expert stacks through qmm_stack above 16 rows and qmm_gather at or below;
and no call of a full-width model through either counted route.

Imports nothing of JAX or of the tpullm package. Exits nonzero without CUDA
or without the repository beside it.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the port's kernels that sum a split K in a second launch; a decode runs
# none of them (qmm and qmm_grouped below 16 rows and qmm_gather sum theirs
# in the same launch)
REDUCTION_KERNELS = ("qmm_reduce_kernel", "qmm_stack_reduce_kernel", "qmm_gather_reduce_kernel")

# NMSE bounds of the JAX package's on-chip conformance sweep
QMM_NMSE_BOUND = 5e-4
FLASH_NMSE_BOUND = 2e-3
FLASH_Q8_NMSE_BOUND = 5e-3

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

# the 8B linears, (name, K = n_in, N = n_out)
QMM_SHAPES = (("qkv", 4096, 6144), ("wo", 4096, 4096), ("gate_up", 4096, 28672),
              ("down", 14336, 4096), ("head", 4096, 128256))
# the 8B FFN linears, held for every format at M in QMM_ROWS
PRESET_QMM_SHAPES = (("gate_up", 4096, 28672), ("down", 14336, 4096))
QMM_ROWS = (1, 8, 16, 512)
COLD_BYTES = 100e6  # plane copies a cold M = 1 timing rotates among, together
# Mixtral's Q5_K attn_output and Q8_0 attn_k/attn_v
MIXTRAL_ATTN_SHAPES = (("wo", 4096, 4096), ("wkv", 4096, 1024))
# Mixtral's expert stacks: 8 experts, gate and up 4096→14336, down 14336→4096
N_EXPERT = 8
EXPERT_SHAPES = (("gate", 4096, 14336), ("down", 14336, 4096))
# the qmm kernel's entry per plane format, and the shapes that hold it
QMM_KEYS = {"Q4_K": "qmm_q4k", "Q6_K": "qmm_q6k", "Q5_K": "qmm_q5k", "Q8_0": "qmm_q8_0",
            "Q4_0": "qmm_q4_0", "Q4_1": "qmm_q4_1", "Q5_0": "qmm_q5_0", "Q5_1": "qmm_q5_1",
            "MXFP4": "qmm_mxfp4", "IQ4_NL": "qmm_iq4_nl", "Q2_K": "qmm_q2k",
            "Q3_K": "qmm_q3k", "IQ4_XS": "qmm_iq4_xs", "IQ2_XXS": "qmm_iq2_xxs",
            "IQ2_XS": "qmm_iq2_xs", "IQ2_S": "qmm_iq2_s", "IQ3_XXS": "qmm_iq3_xxs",
            "IQ3_S": "qmm_iq3_s", "IQ1_S": "qmm_iq1_s", "IQ1_M": "qmm_iq1_m",
            "TQ1_0": "qmm_tq1_0", "TQ2_0": "qmm_tq2_0"}
# the shapes beyond PRESET_QMM_SHAPES that formats hold at M = 1
QMM_EXTRA = {"Q4_K": QMM_SHAPES[:2] + QMM_SHAPES[4:], "Q6_K": QMM_SHAPES[:2] + QMM_SHAPES[4:],
             "Q5_K": MIXTRAL_ATTN_SHAPES, "Q8_0": MIXTRAL_ATTN_SHAPES}
KERNELS = (*QMM_KEYS.values(), "qmm_tc", "qmm_grouped", "qmm_stack", "qmm_gather",
           "flash_bf16", "flash_q8")
# the main path's representative shape per kernel, for the kernels line
REPRESENTATIVE = {"qmm_q4k": "Q4_K gate_up M=1", "qmm_q6k": "Q6_K down M=1",
                  "qmm_q5k": "Q5_K wo M=1", "qmm_q8_0": "Q8_0 wkv M=1",
                  **{QMM_KEYS[f]: f"{f} gate_up M=1" for f in QMM_KEYS if f not in QMM_EXTRA},
                  "qmm_tc": "Q4_K gate_up M=512",
                  "qmm_grouped": "Q4_K gate_up M=1", "qmm_stack": "Q4_K gate M=512 shared",
                  "qmm_gather": "Q4_K gate T=2",
                  "flash_bf16": "bf16 T=1 S=4096", "flash_q8": "q8 T=1 S=4096"}
REPLACES = {**{k: "tpullm/ops/pallas/qmm.py:121" for k in QMM_KEYS.values()},
            "qmm_tc": "tpullm/ops/pallas/qmm.py:121",
            "qmm_grouped": "tpullm/ops/pallas/qmm.py:153",
            "qmm_stack": "tpullm/ops/pallas/qmm.py:288",
            "qmm_gather": "tpullm/ops/pallas/qmm.py:381",
            "flash_bf16": "tpullm/ops/pallas/flash.py:69",
            "flash_q8": "tpullm/ops/pallas/flash.py:69"}
SOURCES = {**{k: "tpullm_torch/csrc/qmm.cu" for k in QMM_KEYS.values()},
           "qmm_tc": "tpullm_torch/csrc/qmm.cu",
           "qmm_grouped": "tpullm_torch/csrc/qmm.cu",
           "qmm_stack": "tpullm_torch/csrc/qmm_moe.cu",
           "qmm_gather": "tpullm_torch/csrc/qmm_moe.cu",
           "flash_bf16": "tpullm_torch/csrc/flash.cu", "flash_q8": "tpullm_torch/csrc/flash.cu"}


def log(*a):
    print(*a, flush=True)


def expect(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nmse(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(((got - ref) ** 2).mean() / (ref * ref).mean().clamp_min(1e-300))


_CAPTURE_STREAM = []  # the one side stream every graph is captured on


def time_ms(fn, iters: int, warmup: int = 2, graph: bool = True) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events). With `graph` the calls are captured once in a CUDA graph and
    the replay is timed, so the time is the device's, not the Python
    wrapper's dispatch (a short kernel launched eagerly back to back is
    timed at the host's pace); without, the calls run eagerly (for plain
    versions that read values back to the host). The warm-up calls run on
    the capture stream (a kernel's counter buffer is made per stream, outside
    the capture)."""
    import torch

    if graph and not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0] if graph else torch.cuda.current_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        del g
        return start.elapsed_time(end) / iters
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / PEAK_BYTES, flops / PEAK_BF16
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    try:
        import regex
        found = f"imports (regex {regex.__version__})"
    except ImportError as e:
        found = f"does not import ({e})"
    log(f"[env] the regex module {found}; tpullm_torch does not use it "
        "(its BPE patterns run on the standard library's re)")
    return smi


def ptxas_entries(report: str) -> list[tuple[str, int, int, int]]:
    """(kernel<template ints>, registers, spill store bytes, spill load
    bytes) of each entry function in an `-Xptxas -v` report."""
    import re

    out, cur, spill = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:  # the mangled name's identifier (length-prefixed) that ends in _kernel
            mangled, cur = m.group(1), m.group(1)[:48]
            for i in range(len(mangled)):
                d = re.match(r"\d+", mangled[i:])
                ident = mangled[i + d.end():i + d.end() + int(d.group())] if d else ""
                if ident.endswith("_kernel") and ident.isidentifier():
                    targs = re.match(r"I((?:Li\d+E)+)E", mangled[i + d.end() + len(ident):])
                    args = re.findall(r"Li(\d+)E", targs.group(1)) if targs else []
                    cur = f"{ident}<{','.join(args)}>"
                    break
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append((cur, int(m.group(1)), *spill))
            cur, spill = None, (0, 0)
    return out


def phase_build():
    from tpullm_torch.ops.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] {len(reports)} libraries in {time.perf_counter() - t0:.1f}s "
        f"into {_build.BUILD_DIR}; nvcc seconds per library "
        f"{ {name: round(sec, 1) for name, (_, sec) in reports.items()} }")
    tc = []
    for name, (rep, _) in reports.items():
        entries = ptxas_entries(rep)
        log(f"[build] {name}: " + "; ".join(f"{k} {r} regs, spill {st}/{ld} B"
                                           for k, r, st, ld in entries))
        tc += [(k, r, st, ld) for k, r, st, ld in entries
               if k.startswith(("qmm_tc_kernel", "qmm_stack_kernel", "qmm_grouped_tc_kernel"))]
    for kind in ("qmm_tc_kernel", "qmm_stack_kernel", "qmm_grouped_tc_kernel"):
        ks = [e for e in tc if e[0].startswith(kind)]
        if ks:
            log(f"[build] {kind}: {len(ks)} instantiations, registers {min(e[1] for e in ks)}–"
                f"{max(e[1] for e in ks)}, spill stores {max(e[2] for e in ks)} B at most, "
                f"spilling: {[e[0] for e in ks if e[2] or e[3]]}")


def _random_planes(gtype, n_out: int, n_in: int, gen, dev):
    """Random packed blocks made on the card (as models/synth.random_packed
    makes them on the host), repacked to device planes."""
    import torch

    from tpullm_torch.gguf.constants import TYPE_TRAITS
    from tpullm_torch.models.synth import write_scales
    from tpullm_torch.ops import qmatmul

    tt = TYPE_TRAITS[gtype]
    nb = n_out * n_in // tt.block_size
    raw = torch.randint(0, 256, (nb, tt.type_size), generator=gen, device=dev,
                        dtype=torch.uint8)
    write_scales(raw, gtype, (torch.rand(nb, generator=gen, device=dev) + 0.5) * 0.02)
    return qmatmul.repack(raw.reshape(-1), gtype, n_out, n_in, dev)


def _cuda_core_qmm(x, planes, gtype, N: int, K: int):
    """The CUDA-core qmm kernel (TM = 8 rows a block) at an M of the
    tensor-core regime, uncounted: the kernel the tensor-core one replaced
    there, timed on the same planes."""
    import torch

    from tpullm_torch.ops.kernels import _build, qmm

    M = x.shape[0]
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    tm, split, per = qmm.gemv_plan(M, K, N, n_sm)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((split if split > 1 else 0, M, N), dtype=torch.float32,
                          device=x.device)
    tiles = -(-N // qmm.GEMV_BLOCK_N) * -(-M // tm)
    fn = _build.bind(f"qmm{qmm._FAMILY[gtype]}", "tpullm_qmm", qmm._QMM_ARGS)
    ops = [planes[qmm._code_plane(gtype)], planes.get("qh"), planes["scale"], planes.get("minus")]
    _build.check(fn(qmm._FMT[gtype], x.data_ptr(), *[None if t is None else t.data_ptr()
                                                     for t in ops],
                    out.data_ptr(), partial.data_ptr(),
                    _build.counters(x.device, torch.cuda.current_stream(x.device).cuda_stream,
                                    tiles).data_ptr(), M, K, N, tm, split, per,
                    torch.cuda.current_stream(x.device).cuda_stream), "cuda-core qmm")
    return out


def cold_ms(fn, copies: list, iters: int) -> float:
    """Mean device time of fn(copy) over `iters` calls rotating among
    `copies` (each a set of planes), so that no call finds its planes left
    in the L2 by the one before."""
    i = iter(range(1 << 30))
    return time_ms(lambda: fn(copies[next(i) % len(copies)]), iters)


def phase_qmm(dev, results: dict):
    """qmm for every format at the 8B gate_up and down, M in QMM_ROWS (the
    CUDA-core kernel at M = 1, the tensor-core kernel at 16 and 512, and at
    512 the CUDA-core kernel on the same planes), and at the formats' other
    main-path shapes at M = 1."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    gen = torch.Generator(dev).manual_seed(0)
    for fmt, key in QMM_KEYS.items():
        gtype = GGMLType[fmt]
        cases = [(shape, QMM_ROWS) for shape in PRESET_QMM_SHAPES]
        cases += [(shape, (1,)) for shape in QMM_EXTRA.get(fmt, ())]
        for (name, K, N), rows in cases:
            planes = _random_planes(gtype, N, K, gen, dev)
            plane_bytes = sum(t.numel() * t.element_size() for t in planes.values())
            w_lib = qmatmul.dequant_planes(planes, gtype, N, K, dtype=torch.bfloat16)
            for M in rows:
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                got = qmm.qmm(x, planes, gtype, N, K)
                ref = qmm.qmm_reference(x, planes, gtype, N, K)
                torch.cuda.synchronize()
                err = nmse(got.float(), ref.float())
                mae = float((got.float() - ref.float()).abs().max())
                label = f"{gtype.name} {name} M={M}"
                expect(bool(torch.isfinite(got.float()).all()), f"{label} finite")
                expect(err <= QMM_NMSE_BOUND, f"{label} NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
                iters = 20 if M < qmm.TC_MIN_M else 5
                ms = time_ms(lambda: qmm.qmm(x, planes, gtype, N, K), iters)
                plain = time_ms(lambda: qmm.qmm_reference(x, planes, gtype, N, K), 2, 1,
                                graph=False)
                lib = time_ms(lambda: torch.matmul(x, w_lib), iters)
                bms, by = bound_ms(M * K * 2 + plane_bytes + M * N * 2, 2.0 * M * K * N)
                row = dict(case=label, nmse=err, max_abs_err=mae, ms=ms, plain_ms=plain,
                           bound_ms=bms, bound_by=by, library_ms=lib,
                           gbps=(plane_bytes + M * K * 2 + M * N * 2) / ms / 1e6,
                           tflops=2.0 * M * K * N / ms / 1e9)
                extra = ""
                if M == 1:
                    row["eager_ms"] = time_ms(lambda: qmm.qmm(x, planes, gtype, N, K), iters,
                                              graph=False)
                    n_copy = max(2, -(-int(COLD_BYTES) // plane_bytes))
                    copies = [planes] + [{k: t.clone() for k, t in planes.items()}
                                         for _ in range(n_copy - 1)]
                    row["cold_ms"] = cold_ms(lambda p: qmm.qmm(x, p, gtype, N, K), copies, 20)
                    row["cold_gbps"] = (plane_bytes + M * K * 2 + M * N * 2) / row["cold_ms"] / 1e6
                    extra = (f" cold {row['cold_ms']:.4f} ms ({row['cold_gbps']:.0f} GB/s); eager "
                             f"back to back {row['eager_ms']:.4f} ms")
                    del copies
                if M == max(QMM_ROWS):
                    cc = _cuda_core_qmm(x, planes, gtype, N, K)
                    torch.cuda.synchronize()
                    expect(nmse(cc.float(), ref.float()) <= QMM_NMSE_BOUND,
                           f"{label} CUDA-core kernel NMSE")
                    row["cuda_core_ms"] = time_ms(lambda: _cuda_core_qmm(x, planes, gtype, N, K),
                                                  3, 1)
                    extra = f" cuda-core kernel {row['cuda_core_ms']:.4f} ms"
                results.setdefault(key if M < qmm.TC_MIN_M else "qmm_tc", []).append(row)
                log(f"[qmm] {label}: nmse {err:.2e} max|d| {mae:.3g} kernel {ms:.4f} ms "
                    f"({row['gbps']:.0f} GB/s, {row['tflops']:.1f} TFLOP/s) bound {bms:.4f} ms "
                    f"({by}) plain {plain:.3f} ms cublas-on-dequantized {lib:.4f} ms{extra}")
            del w_lib, planes
    torch.cuda.empty_cache()


GROUPED_ROWS = (1, 8, 16, 128, 512)


def phase_grouped(dev, results: dict):
    """qmm_grouped, the group-factored kernel, for every format at the 8B
    gate_up and down, M in GROUPED_ROWS (below 16 rows the gemv body, from
    16 the grouped form of the tensor-core body, whose K is split at down
    and summed by qmm_reduce_kernel), against its plain version
    (qmm_grouped_reference), timed beside qmm (the materializing kernel of
    the same regime) on the same planes and cuBLAS on dequantized weights."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    gen = torch.Generator(dev).manual_seed(3)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for fmt in QMM_KEYS:
        gtype = GGMLType[fmt]
        for name, K, N in PRESET_QMM_SHAPES:
            planes = _random_planes(gtype, N, K, gen, dev)
            plane_bytes = sum(t.numel() * t.element_size() for t in planes.values())
            w_lib = qmatmul.dequant_planes(planes, gtype, N, K, dtype=torch.bfloat16)
            for M in GROUPED_ROWS:
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                got = qmm.qmm_grouped(x, planes, gtype, N, K)
                ref = qmm.qmm_grouped_reference(x, planes, gtype, N, K)
                torch.cuda.synchronize()
                err = nmse(got.float(), ref.float())
                mae = float((got.float() - ref.float()).abs().max())
                label = f"{gtype.name} {name} M={M}"
                expect(bool(torch.isfinite(got.float()).all()), f"grouped {label} finite")
                expect(err <= QMM_NMSE_BOUND,
                       f"grouped {label} NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
                tc = M >= qmm.TC_MIN_M
                split = (qmm.plan if tc else qmm.gemv_plan)(M, K, N, n_sm)[1]
                iters = 5 if tc else 20
                ms = time_ms(lambda: qmm.qmm_grouped(x, planes, gtype, N, K), iters)
                mat = time_ms(lambda: qmm.qmm(x, planes, gtype, N, K), iters)
                plain = time_ms(lambda: qmm.qmm_grouped_reference(x, planes, gtype, N, K), 2,
                                1, graph=False)
                lib = time_ms(lambda: torch.matmul(x, w_lib), iters)
                bms, by = bound_ms(M * K * 2 + plane_bytes + M * N * 2, 2.0 * M * K * N)
                results.setdefault("qmm_grouped", []).append(dict(
                    case=label, nmse=err, max_abs_err=mae, ms=ms, qmm_ms=mat, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib, split=split))
                log(f"[grouped] {label} (split {split}): nmse {err:.2e} max|d| {mae:.3g} "
                    f"grouped {ms:.4f} ms, {'qmm_tc' if tc else 'qmm'} on the same planes "
                    f"{mat:.4f} ms ({ms / mat:.3f}×), bound {bms:.4f} ms ({by}) plain "
                    f"{plain:.3f} ms cublas-on-dequantized {lib:.4f} ms")
            del w_lib, planes
    torch.cuda.empty_cache()


def _random_stack(gtype, n_out: int, n_in: int, gen, dev) -> dict:
    """N_EXPERT experts' random planes, stacked [E, rows, N]."""
    import torch

    per = [_random_planes(gtype, n_out, n_in, gen, dev) for _ in range(N_EXPERT)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def phase_moe_kernels(dev, results: dict):
    """qmm_stack and qmm_gather against their plain versions at Mixtral's
    expert shapes; library call: torch.matmul on experts already dequantized
    to bf16 (for the gather, the ids gather of those experts inside the
    timed call)."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    gen = torch.Generator(dev).manual_seed(2)
    M = 512
    for fmt in QMM_KEYS:
        gtype = GGMLType[fmt]
        for name, K, N in EXPERT_SHAPES:
            planes = _random_stack(gtype, N, K, gen, dev)
            expert_bytes = sum(t.numel() * t.element_size() for t in planes.values()) / N_EXPERT
            w_lib = torch.stack([qmatmul.dequant_planes({k: v[e] for k, v in planes.items()},
                                                        gtype, N, K, dtype=torch.bfloat16)
                                 for e in range(N_EXPERT)])  # [E, K, N]
            cases = []
            # a per-expert x moves one stride, the same for every format: Q4_K
            # and Q6_K hold it
            for batched in (False, True) if fmt in ("Q4_K", "Q6_K") else (False,):
                shape = (N_EXPERT, M, K) if batched else (M, K)
                x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                cases.append(("qmm_stack", f"{gtype.name} {name} M={M} "
                              f"{'batched' if batched else 'shared'}",
                              lambda x=x: qmm.qmm_stack(x, planes, gtype, N, K),
                              lambda x=x: qmm.qmm_stack_reference(x, planes, gtype, N, K),
                              lambda x=x: torch.matmul(x, w_lib),
                              x.numel() * 2 + N_EXPERT * expert_bytes + N_EXPERT * M * N * 2,
                              2.0 * N_EXPERT * M * K * N, 3))
            for T, one in ((2, False), (32, False), (32, True)):
                x = torch.randn(T, K, generator=gen, device=dev).to(torch.bfloat16)
                if T == 2:  # one decode token: its top-2, two distinct experts
                    ids = torch.randperm(N_EXPERT, generator=gen, device=dev)[:2].int()
                elif one:  # every slot on one expert: row tiles of 8 of one expert
                    ids = torch.full((T,), 5, device=dev, dtype=torch.int32)
                else:  # the 16-token bucket's slots, with a repeated expert
                    ids = torch.randint(0, N_EXPERT, (T,), generator=gen, device=dev,
                                        dtype=torch.int32)
                    ids[-1] = ids[0]
                n_unique = int(torch.unique(ids).numel())  # the experts this run reads
                cases.append(("qmm_gather", f"{gtype.name} {name} T={T}"
                              f"{' one expert' if one else ''}",
                              lambda x=x, ids=ids: qmm.qmm_gather(x, ids, planes, gtype, N, K),
                              lambda x=x, ids=ids: qmm.qmm_gather_reference(x, ids, planes,
                                                                            gtype, N, K),
                              lambda x=x, ids=ids: torch.bmm(x[:, None, :],
                                                             w_lib[ids.long()])[:, 0],
                              x.numel() * 2 + T * 4 + n_unique * expert_bytes + T * N * 2,
                              2.0 * T * K * N, 20 if T == 2 else 5))
            # ids outside 0..E-1 give NaN rows, the others their expert's product
            x = torch.randn(4, K, generator=gen, device=dev).to(torch.bfloat16)
            ids = torch.tensor([3, N_EXPERT, -1, 3], device=dev, dtype=torch.int32)
            got = qmm.qmm_gather(x, ids, planes, gtype, N, K)
            ref = qmm.qmm_gather_reference(x[[0, 3]], ids[[0, 3]], planes, gtype, N, K)
            torch.cuda.synchronize()
            err = nmse(got[[0, 3]].float(), ref.float())
            expect(bool(torch.isnan(got[[1, 2]].float()).all()),
                   f"qmm_gather {gtype.name} {name}: NaN rows for ids outside the stack")
            expect(err <= QMM_NMSE_BOUND, f"qmm_gather {gtype.name} {name} beside invalid ids: "
                   f"NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
            log(f"[moe] qmm_gather {gtype.name} {name} ids {ids.tolist()}: NaN rows 1, 2; "
                f"rows 0, 3 nmse {err:.2e}")
            for key, label, kernel, plain, library, n_bytes, flops, iters in cases:
                got, ref = kernel(), plain()
                torch.cuda.synchronize()
                err = nmse(got.float(), ref.float())
                mae = float((got.float() - ref.float()).abs().max())
                expect(bool(torch.isfinite(got.float()).all()), f"{key} {label} finite")
                expect(err <= QMM_NMSE_BOUND, f"{key} {label} NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
                bms, by = bound_ms(n_bytes, flops)
                row = dict(case=label, nmse=err, max_abs_err=mae, ms=time_ms(kernel, iters),
                           plain_ms=time_ms(plain, 1, 1, graph=False), bound_ms=bms, bound_by=by,
                           library_ms=time_ms(library, iters))
                row["gbps"] = n_bytes / row["ms"] / 1e6
                row["tflops"] = flops / row["ms"] / 1e9
                results.setdefault(key, []).append(row)
                log(f"[moe] {key} {label}: nmse {err:.2e} max|d| {mae:.3g} kernel "
                    f"{row['ms']:.4f} ms ({row['gbps']:.0f} GB/s, {row['tflops']:.1f} TFLOP/s) "
                    f"bound {bms:.4f} ms ({by}) plain {row['plain_ms']:.3f} ms "
                    f"matmul-on-dequantized {row['library_ms']:.4f} ms")
            del planes, w_lib, cases
            torch.cuda.empty_cache()


def _flash_case(dev, gen, *, q8, B, T, H, Hkv, D, S, offsets, softcap=0.0, window=0,
                sinks=False, alibi=False, timed=False):
    import torch
    import torch.nn.functional as F

    from tpullm_torch.ops.kernels import flash
    from tpullm_torch.runtime.kvcache import QuantKVCache

    q = torch.randn(B, T, H, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    sk = torch.randn(H, generator=gen, device=dev) if sinks else None
    sl = torch.linspace(0.5, 0.01, H, device=dev) if alibi else None
    scale = D ** -0.5
    if q8:
        k_q, k_s = QuantKVCache._quantize(k)
        v_q, v_s = QuantKVCache._quantize(v)
        kv = (k_q, v_q)
        kw = dict(k_scale=k_s, v_scale=v_s)

        def kernel():
            return flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, scale, softcap,
                                            window, sk, sl)
        k_lib = (k_q.float() * k_s[..., None]).to(torch.bfloat16)
        v_lib = (v_q.float() * v_s[..., None]).to(torch.bfloat16)
    else:
        kv, kw = (k, v), {}

        def kernel():
            return flash.flash_attention(q, k, v, off, scale, softcap, window, sk, sl)
        k_lib, v_lib = k, v

    def plain():
        return flash.flash_reference(q, *kv, off, scale, softcap, window, sk, sl, **kw)
    decode = flash.regime(T, H, Hkv) == "decode"
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    row = dict(regime="decode" if decode else "prefill", nmse=nmse(got.float(), ref.float()),
               max_abs_err=float((got.float() - ref.float()).abs().max()),
               finite=bool(torch.isfinite(got.float()).all()))
    if not timed:
        return row
    # the plain version of the kernel's own order: its split plan, or its
    # tiles with p rounded as it rounds it (and, beside it, one bf16 term)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if decode:
        own = flash.flash_split_reference(q, *kv, off, scale, softcap, window, sk, sl,
                                          n_sm=n_sm, **kw)
    else:
        own = flash.flash_prefill_reference(q, *kv, off, scale, softcap, window, sk, sl, **kw)
        q32 = q.float()
        exact = flash.flash_reference(q32, *kv, off, scale, softcap, window, sk, sl, **kw)
        for terms in (1, 2):
            rounded = flash.flash_prefill_reference(q32, *kv, off, scale, softcap, window, sk,
                                                    sl, p_terms=terms, **kw)
            row[f"p_terms{terms}_nmse"] = nmse(rounded, exact)
        del exact, rounded
    row["nmse_own_order"] = nmse(got.float(), own.float())
    # work this run's data needs: keys up to each row's position, per head
    q_pos = np.asarray(offsets)[:, None] + np.arange(T)[None]
    visible = float(np.minimum(q_pos + 1, S).sum())
    kv_len = np.minimum(np.asarray(offsets) + T, S)
    per_pos = D * (1 if q8 else 2) + (4 if q8 else 0)  # bytes of one K (or V) row
    n_bytes = 2 * q.numel() * 2 + 2 * float(kv_len.sum()) * Hkv * per_pos
    bms, by = bound_ms(n_bytes, 4.0 * D * H * visible)
    pos = torch.arange(S, device=dev)
    mask = (pos[None, None, :] <= (off[:, None] + torch.arange(T, device=dev))[..., None])
    mask = mask[:, None]  # [B, 1, T, S]
    qt = q.transpose(1, 2)
    k_lib = k_lib.repeat_interleave(H // Hkv, dim=1)  # GQA heads expanded outside the timing
    v_lib = v_lib.repeat_interleave(H // Hkv, dim=1)

    def library():
        return F.scaled_dot_product_attention(qt, k_lib, v_lib, attn_mask=mask, scale=scale)
    row.update(ms=time_ms(kernel, 20), eager_ms=time_ms(kernel, 20, graph=False),
               plain_ms=time_ms(plain, 2, 1, graph=False), bound_ms=bms, bound_by=by,
               library_ms=time_ms(library, 20), visible_pairs_per_head=visible / B)
    return row


def phase_flash(dev, results: dict):
    import torch

    gen = torch.Generator(dev).manual_seed(1)
    main = dict(B=2, H=32, Hkv=8, D=128, S=4096)
    for q8, key in ((False, "flash_bf16"), (True, "flash_q8")):
        bound = FLASH_Q8_NMSE_BOUND if q8 else FLASH_NMSE_BOUND
        fmt = "q8" if q8 else "bf16"
        one = dict(main, B=1)
        cases = [(f"{fmt} T=1 S=4096", dict(T=1, offsets=(37, 3000), **main)),
                 (f"{fmt} T=512 S=4096", dict(T=512, offsets=(0, 2500), **main)),
                 # the 8B's decode at a short context (the serving profile's)
                 (f"{fmt} T=1 B=1 kv=20 S=4096", dict(T=1, offsets=(19,), **one)),
                 (f"{fmt} T=1 B=1 kv=100 S=4096", dict(T=1, offsets=(99,), **one))]
        small = dict(B=2, H=8, Hkv=2, S=300)
        cases += [
            ("softcap", dict(T=40, offsets=(0, 250), D=128, softcap=30.0, **small)),
            ("window", dict(T=40, offsets=(5, 200), D=64, window=48, **small)),
            ("sinks", dict(T=1, offsets=(0, 280), D=128, sinks=True, **small)),
            ("alibi", dict(T=33, offsets=(10, 240), D=64, alibi=True, **small)),
            ("all", dict(T=20, offsets=(3, 270), D=128, softcap=25.0, window=32, sinks=True,
                         alibi=True, **small)),
            ("all decode", dict(T=4, offsets=(3, 270), D=64, softcap=25.0, window=32, sinks=True,
                                alibi=True, **small)),
        ]
        for label, kw in cases:
            timed = "S=4096" in label
            row = _flash_case(dev, gen, q8=q8, timed=timed, **kw)
            row["case"] = label if timed else f"{'q8' if q8 else 'bf16'} {label}"
            expect(row["finite"], f"flash {row['case']} finite")
            expect(row["nmse"] <= bound, f"flash {row['case']} NMSE {row['nmse']:.3e} <= {bound}")
            results.setdefault(key, []).append(row)
            extra = ""
            if timed:
                expect(row["nmse_own_order"] <= bound, f"flash {row['case']} against the plain "
                       f"version of its own order: NMSE {row['nmse_own_order']:.3e}")
                extra = (f" (against its own order's plain version {row['nmse_own_order']:.2e})"
                         f" kernel {row['ms']:.4f} ms (eager back to back {row['eager_ms']:.4f})"
                         f" bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_by']}) plain {row['plain_ms']:.3f} ms "
                         f"sdpa {row['library_ms']:.4f} ms")
                if "p_terms1_nmse" in row:
                    extra += (f"; p for the PV product as one bf16 term: NMSE "
                              f"{row['p_terms1_nmse']:.2e}, as two: {row['p_terms2_nmse']:.2e} "
                              "(plain versions, f32 output, against f32 p)")
            log(f"[flash] {row['case']} ({row['regime']}): nmse {row['nmse']:.2e} max|d| "
                f"{row['max_abs_err']:.3g}{extra}")
    torch.cuda.empty_cache()


def reset_launches():
    from tpullm_torch.runtime.graph import launch_counts

    for d in launch_counts():
        for k in d:
            d[k] = 0


def read_launches() -> dict:
    """Launches per kernel entry of KERNELS (qmm_<format>: the CUDA-core
    regime; qmm_tc: the tensor-core regime, every format), the grouped,
    tensor-core and expert kernels' by format ("qmm_stack.MXFP4", ...), the
    flash launches of the decode regime ("flash_bf16.decode"), and the calls
    of the two counted routes."""
    from tpullm_torch.ops.kernels import flash, qmm

    got = {key: qmm.LAUNCHES[fmt] for fmt, key in QMM_KEYS.items()}
    got.update({"qmm_tc": sum(qmm.TC_LAUNCHES.values()),
                "qmm_grouped": sum(qmm.GROUPED_LAUNCHES.values()),
                "qmm_stack": sum(qmm.STACK_LAUNCHES.values()),
                "qmm_gather": sum(qmm.GATHER_LAUNCHES.values()),
                "flash_bf16": flash.LAUNCHES["bf16"], "flash_q8": flash.LAUNCHES["q8"],
                "flash_bf16.decode": flash.DECODE_LAUNCHES["bf16"],
                "flash_q8.decode": flash.DECODE_LAUNCHES["q8"],
                "dequant_routes": sum(qmm.DEQUANT_ROUTES.values()),
                "attn_dense_routes": sum(flash.ATTN_DENSE_ROUTES.values())})
    for kind, counts in (("qmm_tc", qmm.TC_LAUNCHES), ("qmm_grouped", qmm.GROUPED_LAUNCHES),
                         ("qmm_stack", qmm.STACK_LAUNCHES), ("qmm_gather", qmm.GATHER_LAUNCHES)):
        got.update({f"{kind}.{fmt}": n for fmt, n in counts.items() if n})
    return got


def per_forward_launches(params) -> dict:
    """Kernel launches one forward makes: 2-D qmm in the layers (each
    quantized linear, fused or not) and for the head (on the last row only),
    expert kernels (each expert stack: in the gather regime qmm_gather, else
    qmm_stack) and flash (one per layer)."""
    from tpullm_torch.models.weights import FusedLinear, QuantExpertStack, QuantLinear

    def is_quant(m):
        return isinstance(m.base if isinstance(m, FusedLinear) else m, QuantLinear)

    head = int(is_quant(params["output"])) if params["output"] is not None else 0
    layers = experts = 0
    for layer in params["layers"]:
        layers += sum(is_quant(m) for m in layer.values()
                      if isinstance(m, (QuantLinear, FusedLinear)))
        experts += sum(isinstance(m, QuantExpertStack) for m in layer.values())
    return {"qmm": layers + head, "qmm_layers": layers, "head": head, "experts": experts,
            "flash": len(params["layers"])}


def flash_decode_forwards(hp, rows: list[int]) -> int:
    """The forwards among `rows` whose attention takes flash's decode regime."""
    from tpullm_torch.ops.kernels import flash

    return sum(flash.regime(r, hp.n_head, hp.n_head_kv) == "decode" for r in rows)


def bucket_rows(n_tokens: int) -> int:
    """The rows a forward over n_tokens runs (batch 1): its prefill bucket,
    1 at decode."""
    from tpullm_torch.runtime.engine import PREFILL_BUCKETS

    return next(b for b in PREFILL_BUCKETS if n_tokens <= b)


def check_launches(label: str, got: dict, per: dict, rows: list[int], kv: str,
                   decode_fw: int):
    """Launch counts of a run against per-forward counts and the rows of
    each forward (its bucket; 1 at decode): the 2-D qmm of the layers on
    the tensor cores from TC_MIN_M rows and on CUDA cores below, the head on
    CUDA cores (one row), unless the run sent them to qmm_grouped; the
    expert stacks through qmm_stack above the gather threshold and
    qmm_gather at or below it; no call through either counted route."""
    from tpullm_torch.ops import moe
    from tpullm_torch.ops.kernels import qmm

    n = len(rows)
    tc_fw = sum(r >= qmm.TC_MIN_M for r in rows)
    stack_fw = sum(r > moe._GATHER_MAX_TOKENS for r in rows)
    cc_got = sum(got[k] for k in QMM_KEYS.values())
    fkey = "flash_bf16" if kv == "bf16" else "flash_q8"
    log(f"[{label}] launches {got} over {n} forwards ({tc_fw} of ≥ {qmm.TC_MIN_M} rows, "
        f"{stack_fw} of > {moe._GATHER_MAX_TOKENS}); per forward {per}")
    expect(cc_got + got["qmm_tc"] + got["qmm_grouped"] == per["qmm"] * n,
           f"{label}: qmm launches {cc_got} + {got['qmm_tc']} + {got['qmm_grouped']} = "
           f"{per['qmm']} × {n}")
    if got["qmm_grouped"] == 0:
        expect(got["qmm_tc"] == per["qmm_layers"] * tc_fw,
               f"{label}: tensor-core qmm launches {got['qmm_tc']} = {per['qmm_layers']} × "
               f"{tc_fw} forwards of ≥ {qmm.TC_MIN_M} rows")
        expect(cc_got == per["qmm_layers"] * (n - tc_fw) + per["head"] * n,
               f"{label}: CUDA-core qmm launches {cc_got} = {per['qmm_layers']} × "
               f"{n - tc_fw} forwards of < {qmm.TC_MIN_M} rows + {per['head']} heads × {n} "
               "(none at ≥ 16 rows)")
    expect(got[fkey] == per["flash"] * n, f"{label}: {fkey} launches = {per['flash']} × {n}")
    expect(got[fkey + ".decode"] == per["flash"] * decode_fw,
           f"{label}: {fkey} decode-regime launches {got[fkey + '.decode']} = {per['flash']} × "
           f"{decode_fw} forwards (the rest prefill-regime)")
    expect(got["qmm_gather"] == per["experts"] * (n - stack_fw),
           f"{label}: qmm_gather launches {got['qmm_gather']} = {per['experts']} × "
           f"{n - stack_fw} gather-regime forwards")
    expect(got["qmm_stack"] == per["experts"] * stack_fw,
           f"{label}: qmm_stack launches {got['qmm_stack']} = {per['experts']} × "
           f"{stack_fw} stack-regime forwards")
    expect(got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0,
           f"{label}: no call through the dequantize or dense-attention routes")


def phase_tiny(dev, tmp: Path):
    """The tiny dense model at every dense preset and the tiny MoE at
    Q4_K_M, MXFP4_MOE and IQ2_XXS on the card against the same models on the
    CPU: logits NMSE ≤ 1e-3, greedy ids equal."""
    import torch

    from tpullm_torch.models.synth import PRESETS, make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    fox = "the quick brown fox jumps over the lazy dog"
    # 52 tokens: the all-experts regime at prefill, the gather regime at decode
    dog = "the lazy dog jumps over the quick brown fox hello world"
    runs = [("tiny", "Q4_K_M", torch.bfloat16, fox), ("tiny", "Q4_K_M", "q8_0", fox),
            ("tiny-moe", "Q4_K_M", torch.bfloat16, dog),
            ("tiny-moe", "Q4_K_M", torch.bfloat16, "hello world"),  # a gather-regime prefill
            *[("tiny", ftype, torch.bfloat16, fox) for ftype in PRESETS
              if ftype not in ("Q4_K_M", "MXFP4_MOE")],
            ("tiny", "Q2_K", "q8_0", fox), ("tiny-moe", "MXFP4_MOE", torch.bfloat16, dog),
            ("tiny-moe", "IQ2_XXS", torch.bfloat16, dog)]
    for shape, ftype, kv, prompt in runs:
        path = make_synthetic_llama_gguf(tmp / f"{shape}-{ftype}.gguf", shape=shape, seed=0,
                                         ftype=ftype)
        gpu = Engine(path, max_seq=256, kv_dtype=kv)
        cpu = Engine(path, device="cpu", max_seq=256, kv_dtype=kv)
        ids = gpu.tokenizer.tokenize(prompt)
        errs = [nmse(torch.from_numpy(gpu.prefill(ids)), torch.from_numpy(cpu.prefill(ids)))]
        for tok in (300, 17, 42, 260, 5):
            errs.append(nmse(torch.from_numpy(gpu.decode_step(tok)),
                             torch.from_numpy(cpu.decode_step(tok))))
        gpu.reset()
        cpu.reset()
        a = gpu.generate_tokens_device(ids, 16)
        b = cpu.generate_tokens_device(ids, 16)
        kv_name = "bf16" if kv is torch.bfloat16 else kv
        what = f"{shape} {ftype} kv={kv_name}"
        log(f"[tiny] {what} {len(ids)}-token prompt: logits NMSE card vs cpu "
            f"max {max(errs):.2e}; greedy {'equal' if a == b else 'DIFFERENT'}")
        expect(max(errs) <= 1e-3, f"{what} logits NMSE {max(errs):.3e} <= 1e-3")
        expect(a == b, f"{what} greedy ids card {a} vs cpu {b}")
        if (shape, ftype, kv) == ("tiny", "Q4_K_M", torch.bfloat16):
            grammar_run(gpu, cpu)


# words of lower-case letters, each after a space
GRAMMAR_WORDS = r'root ::= (" " [a-z]+)+'


def grammar_run(gpu, cpu):
    """generate_tokens through a GBNF grammar (GRAMMAR_WORDS) and a greedy
    Sampler with repetition penalties, on the card and on the CPU: the same
    ids, every one allowed by the grammar."""
    from tpullm_torch.grammar import GrammarConstraint
    from tpullm_torch.runtime.sampling import Sampler, SamplerParams

    def sampler(eng):
        c = GrammarConstraint.from_tokenizer(GRAMMAR_WORDS, eng.tokenizer)
        return Sampler(SamplerParams(temp=0.0, penalty_repeat=1.5, penalty_last_n=-1,
                                     penalty_freq=0.2, seed=42),
                       constraint_fn=c, constraint_accept=c.accept)

    ids = gpu.tokenizer.tokenize("hello world")
    outs = []
    for eng in (gpu, cpu):
        eng.reset()
        outs.append(list(eng.generate_tokens(ids, 24, sampler(eng))))
    text = gpu.tokenizer.detokenize(outs[0])
    log(f"[tiny] generate_tokens with the grammar {GRAMMAR_WORDS!r} and a penalised sampler: "
        f"card {outs[0]} {'equal to' if outs[0] == outs[1] else 'NOT'} the CPU's; text {text!r}")
    expect(outs[0] == outs[1], f"grammar run: card ids {outs[0]} vs cpu {outs[1]}")
    expect(len(outs[0]) > 0 and all(w.isalpha() and w.islower() for w in text.split()),
           f"grammar run: {text!r} is lower-case words")


PROFILE_MARGIN_S = 0.005  # host time between the recorded window's edges and fn's launches


def profiled(fn):
    """fn() under torch.profiler (CPU and CUDA activity) after one warm-up
    step of the profiler, in which it traces one small launch, with
    PROFILE_MARGIN_S of host time before fn's first launch and after its
    last kernel ends: kernels near the start of a trace went missing (the
    first qmm launches of a 512-token prefill were absent from it). Returns
    (fn's result, the profile of fn alone; `device_events` reads it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_MARGIN_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
    return out, prof


def device_events(prof):
    """(key, device µs, count) of each event with device time in a
    profile, without the profiler's own step ranges (which the profiler
    credits with the device time of the kernels launched under them that no
    other operator claims: the graph replays and the port's kernels)."""
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if us > 0.0 and not e.key.startswith("ProfilerStep"):
            yield e.key, us, e.count


def _family(key: str) -> str:
    return next((k for k in ("qmm_stack", "qmm_gather", "qmm") if k in key),
                "flash" if "flash_" in key else "other")


def run_steps(runner, n: int, eager: bool = False) -> list[int]:
    """`n` decode steps of `runner` from its buffers' state, ids read back
    once: runner.run (graph replays on the card), or with `eager` the
    runner's step called n times on the current stream, no graph (the
    eager yardstick the graph is timed against)."""
    if not eager:
        return runner.run(n)
    runner.step_index.zero_()
    for _ in range(n):
        runner.step()
    return runner.ids[:n].tolist()


def _start(eng, runner, prompt) -> None:
    """A fresh prefill of `prompt`; its greedy id loaded into `runner`."""
    import torch

    eng.reset()
    with torch.inference_mode():
        runner.start(torch.tensor(int(np.argmax(eng.prefill(prompt))), device=eng.device),
                     eng.n_past)
    torch.cuda.synchronize()


def profile_decode(eng, runner, ids, steps: int, eager: bool = False) -> dict:
    """Device time a decode step by kernel family over `steps` decode steps
    of `runner` (one run) after a prefill of `ids`: replays of its CUDA
    graph, the main path, or with `eager` the same steps without a graph;
    from torch.profiler (`profiled`). Beside it the launches of each of the
    port's reduction kernels (REDUCTION_KERNELS) among them: 0, as every
    kernel a decode runs sums its K split in its own launch; and the
    CUDA-event span of the steps on the card."""
    import torch

    _start(eng, runner, ids)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def steps_run():
        start.record()
        with torch.inference_mode():
            run_steps(runner, steps, eager)
        end.record()

    _, prof = profiled(steps_run)
    fam = {"qmm": 0.0, "qmm_stack": 0.0, "qmm_gather": 0.0, "flash": 0.0, "other": 0.0}
    top, reduce_launches = [], dict.fromkeys(REDUCTION_KERNELS, 0)
    for key, us, n in device_events(prof):
        fam[_family(key)] += us
        top.append((us, key, n))
        for name in REDUCTION_KERNELS:  # no name is part of another
            if name in key:
                reduce_launches[name] += n
    top.sort(reverse=True)
    return {"steps": steps, "graph": not eager, "reduce_launches": reduce_launches,
            "device_ms_per_token": {k: v / 1e3 / steps for k, v in fam.items()},
            "event_span_ms_per_token": start.elapsed_time(end) / steps,
            "top": [(name[:60], round(us / 1e3 / steps, 4), n) for us, name, n in top[:8]]}


def profile_prefill(eng, ids) -> dict:
    """Device time of one prefill of `ids` by kernel family, from
    torch.profiler (`profiled`), beside its wall time (prompt in, logits on
    the host), and the launches of each of the port's kernels by name."""
    import re

    import torch

    eng.reset()
    torch.cuda.synchronize()

    def prefill():
        t0 = time.perf_counter()
        eng.prefill(ids)
        return time.perf_counter() - t0

    wall, prof = profiled(prefill)
    fam = {"qmm_tc": 0.0, "qmm_grouped": 0.0, "qmm_stack": 0.0, "qmm": 0.0, "flash": 0.0,
           "other": 0.0}
    launches: dict = {}
    for key, us, n in device_events(prof):
        kind = next((k for k in ("qmm_tc", "qmm_grouped", "qmm_stack", "qmm") if k in key),
                    "flash" if "flash_" in key else "other")
        fam[kind] += us
        m = re.search(r"\b((?:qmm|flash)_\w*kernel)\b", key)
        if m:
            launches[m.group(1)] = launches.get(m.group(1), 0) + n
    return {"device_ms": {k: v / 1e3 for k, v in fam.items()}, "wall_ms": wall * 1e3,
            "launches": launches}


def plane_bytes(params, n_expert_used: int) -> tuple[float, float]:
    """(bytes of every plane resident on the card, plane bytes one decode
    token streams: every 2-D linear and the head, and n_expert_used
    experts of each stack)."""
    import torch

    from tpullm_torch.models.weights import QuantExpertStack

    def nbytes(m):
        return sum(b.numel() * b.element_size() for b in m.buffers())

    resident = per_token = 0.0
    for m in [params["output"], *[v for layer in params["layers"] for v in layer.values()]]:
        if not isinstance(m, torch.nn.Module):
            continue
        resident += nbytes(m)
        per_token += (nbytes(m) / m.n_expert * n_expert_used
                      if isinstance(m, QuantExpertStack) else nbytes(m))
    return resident, per_token


def serve(label: str, path, kv, launches: dict, lens: tuple | None = None,
          short: int | None = None, n_gen: int = 64, prefill_len: int | None = None,
          graph: bool = False) -> dict:
    """Serves the GGUF at `path` through Engine: one warm-up generation,
    then three prompts and the second again, `n_gen` greedy tokens each
    (the decode chunk as CUDA-graph replays); a profiled chunk of replays;
    launch counts against the expected count per
    forward of each MoE regime. The prompts are "hello world", its words
    six times and 512 word tokens (10, 307 and 512 tokens), or, with
    `lens`, BOS and word tokens to those lengths. With `short`, one prompt
    of that many word tokens and 16 greedy tokens (16 decode steps) instead
    (a model cut to a few layers: its TTFT says little); with `prefill_len`
    as well, a profiled prefill of that many word tokens. With `graph`,
    the graph phase (`graph_decode`) on the same engine."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine

    n_gen = 16 if short else n_gen
    chunk = 16 if short else 32
    kv_name = "bf16" if kv is torch.bfloat16 else "q8_0"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # just before the main path
    eng = Engine(path, max_seq=4096, kv_dtype=kv)
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    resident, per_token = plane_bytes(eng.params, max(eng.hp.n_expert_used, 1))
    log(f"[{label}] kv={kv_name}: {eng.hp.n_layer} layers loaded in {eng.perf.t_load_s:.1f}s "
        f"(peak memory {load_peak:.2f} GiB); "
        f"planes resident {resident / 2**30:.2f} GiB; one decode token streams "
        f"{per_token / 1e9:.3f} GB of planes, a bound of "
        f"{per_token / PEAK_BYTES * 1e3:.3f} ms per token")
    tok = eng.tokenizer
    words = "the quick brown fox jumps over the lazy dog hello world".split()
    space = "Ġ" if tok.vocab.model == "gpt2" else "▁"  # a word's leading space in the vocab

    def word_ids(n: int) -> list[int]:
        return [tok.vocab.special.bos] + [tok.vocab.token_to_id[space + words[i % len(words)]]
                                          for i in range(n - 1)]

    if short:
        prompts = [word_ids(short)]
    elif lens is None:
        prompts = [tok.tokenize("hello world"), tok.tokenize(" ".join(words * 6)), word_ids(512)]
    else:
        prompts = [word_ids(n) for n in lens]
    expect(short or len(prompts[2]) == 512, "the long prompt has 512 tokens")
    rows: list[int] = []  # the rows of each forward: its prefill bucket, 1 at decode

    def count(n_prompt: int, n_decode: int):
        rows.append(bucket_rows(n_prompt))
        rows.extend([1] * n_decode)

    # one short generation first, at the prompts' chunk: lazy set-up
    # (allocator, first launches, the decode graph's capture) is paid once
    # per process, not per request
    eng.generate_tokens_device(prompts[0], 8, temp=0.0, stop_on_eog=False, chunk=chunk)
    count(len(prompts[0]), eng.perf.n_decode)
    per_prompt = []
    for i, ids in enumerate(prompts if short else prompts + [prompts[1]]):
        eng.reset()
        p0 = (eng.perf.t_prefill_s, eng.perf.t_decode_s, eng.perf.n_decode)
        out = eng.generate_tokens_device(ids, n_gen, temp=0.0, stop_on_eog=False, chunk=chunk)
        ttft = eng.perf.t_prefill_s - p0[0]
        dec_s, dec_n = eng.perf.t_decode_s - p0[1], eng.perf.n_decode - p0[2]
        count(len(ids), dec_n)
        expect(len(out) == n_gen, f"prompt {i}: {len(out)} tokens generated")
        expect(all(0 <= t < eng.hp.n_vocab for t in out), "token ids in range")
        per_prompt.append(dict(n_prompt=len(ids), ttft_s=ttft, decode_tok_s=dec_n / dec_s,
                               out=out))
        log(f"[{label}] kv={kv_name} prompt {i} ({len(ids)} tok, bucket {bucket_rows(len(ids))}): "
            f"TTFT {ttft * 1e3:.1f} ms ({len(ids) / ttft:.1f} tok/s prefill), decode "
            f"{dec_n / dec_s:.2f} tok/s over {dec_n} steps, first ids {out[:6]}, text "
            f"{tok.detokenize(out[:12])!r}")
    if not short:
        expect(per_prompt[3]["out"] == per_prompt[1]["out"], "greedy output is deterministic")
    prof = profile_decode(eng, eng.decode_runner(SamplingParams(), chunk), prompts[0], chunk)
    count(len(prompts[0]), prof["steps"])
    expect(sum(prof["reduce_launches"].values()) == 0,
           f"{label}: no reduction kernel in the decode profile ({prof['reduce_launches']})")
    busy = sum(prof["device_ms_per_token"].values())
    wall = 1e3 / float(np.median([p["decode_tok_s"] for p in per_prompt]))
    log(f"[{label}] kv={kv_name} profile of {chunk} decode steps as graph replays: device ms "
        "per decode token "
        f"{ {k: round(v, 4) for k, v in prof['device_ms_per_token'].items()} } = "
        f"{busy:.3f} ms busy of {wall:.3f} ms per token unprofiled (median rate) "
        f"(idle share {1 - busy / wall:.3f}); reduction launches {prof['reduce_launches']}; "
        f"top {prof['top']}"
        if busy > 0 else f"[{label}] kv={kv_name} profile: no device time recorded "
        "(device busy share not measured)")
    graph_run = graph_decode(label, kv_name, eng, word_ids, count, prof) if graph else None
    prefill_prof = None
    if not short or prefill_len:
        long_ids = word_ids(prefill_len) if short else prompts[2]
        prefill_prof = profile_prefill(eng, long_ids)
        count(len(long_ids), 0)
        busy_p = sum(prefill_prof["device_ms"].values())
        log(f"[{label}] kv={kv_name} profile: one {len(long_ids)}-token prefill, device ms "
            f"{ {k: round(v, 3) for k, v in prefill_prof['device_ms'].items()} } = "
            f"{busy_p:.3f} ms busy of {prefill_prof['wall_ms']:.3f} ms wall (profiled) "
            f"(idle share {1 - busy_p / prefill_prof['wall_ms']:.3f}); launches "
            f"{prefill_prof['launches']}")
    eng.reset()
    logits = eng.prefill(prompts[0])
    count(len(prompts[0]), 0)
    expect(logits.shape == (eng.hp.n_vocab,) and bool(np.isfinite(logits).all()),
           "final logits finite, [n_vocab]")
    torch.cuda.synchronize()
    got = read_launches()  # just after the main path
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{label}] kv={kv_name}: load {eng.perf.t_load_s:.1f}s, peak memory {peak:.2f} GiB")
    per = per_forward_launches(eng.params)
    check_launches(f"{label} kv={kv_name}", got, per, rows, kv_name,
                   flash_decode_forwards(eng.hp, rows))
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    run = dict(model=label, kv=kv_name, n_layer=eng.hp.n_layer, load_s=eng.perf.t_load_s,
               load_peak_gib=load_peak, peak_gib=peak, resident_gib=resident / 2**30,
               decode_plane_gb=per_token / 1e9,
               decode_bound_ms=per_token / PEAK_BYTES * 1e3,
               ttft_ms=[p["ttft_s"] * 1e3 for p in per_prompt],
               n_prompt=[p["n_prompt"] for p in per_prompt],
               decode_tok_s=[p["decode_tok_s"] for p in per_prompt],
               launches=got, per_forward=per, forwards=len(rows),
               prefill_forwards={r: rows.count(r) for r in sorted(set(rows)) if r > 1},
               device_ms_per_token=prof["device_ms_per_token"],
               decode_reduce_launches=prof["reduce_launches"],
               idle_share=(1 - busy / wall) if busy > 0 else None, prefill_profile=prefill_prof,
               graph=graph_run)
    if not short:
        run["pp512_tok_s"] = 512 / per_prompt[2]["ttft_s"]
    del eng
    torch.cuda.empty_cache()
    return run


GRAPH_CHUNK = 32  # decode steps a chunk (the Engine's default)
GRAPH_TAIL = 6  # steps after the second chunk in the ids check
EAGER_PROFILE_STEPS = 8  # eager steps profiled as the yardstick's busy time


def time_runs(eng, runner, prompt, runs: int, eager: bool = False) -> float:
    """Wall ms a decode step over `runs` chunks of `run_steps` after a
    prefill of `prompt` (ids read back once a chunk, as generate does)."""
    import torch

    _start(eng, runner, prompt)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(runs):
            run_steps(runner, runner.chunk, eager)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (runs * runner.chunk)


def _decode_summary(prof: dict, wall_ms: float) -> dict:
    """Busy and idle a token of a decode profile against a wall time; where
    the profiler listed no kernel, the CUDA-event span stands for busy."""
    busy = sum(prof["device_ms_per_token"].values())
    listed = busy > 0
    busy = busy if listed else prof["event_span_ms_per_token"]
    return dict(wall_ms=wall_ms, tok_s=1e3 / wall_ms, busy_ms=busy,
                busy_from="profiler" if listed else "CUDA-event span (profiler listed no kernel)",
                idle_share=1 - busy / wall_ms, device_ms_per_token=prof["device_ms_per_token"],
                event_span_ms_per_token=prof["event_span_ms_per_token"])


def graph_decode(label: str, kv_name: str, eng, word_ids, count, graph_prof: dict) -> dict:
    """The decode chunk as CUDA-graph replays, on a served engine:
    1. greedy ids: a prompt of max_seq − 2·GRAPH_CHUNK − GRAPH_TAIL word
       tokens, generate_tokens_device to the context end (two chunks of
       replays and a tail of one-step replays) against a decode_step +
       argmax loop on the same engine;
    2. the launches one replay adds against per_forward_launches;
    3. the graph's capture seconds and pool bytes;
    4. decode wall ms a token, in turns (eager, graph, graph, eager) after
       a 10-token prompt: the runner's steps without a graph (the eager
       yardstick, one chunk a turn) and its replays (two chunks a turn);
    5. busy and idle a token: the replays' from `graph_prof` (serve's
       profile of one chunk of replays), the eager steps' from a profile of
       EAGER_PROFILE_STEPS of them;
    6. temp 0.8: two runs from one seed give the same ids.
    `count(n_prompt, n_decode)` books every forward for check_launches."""
    from tpullm_torch.ops.sampling_ops import SamplingParams

    tag = f"[{label}] kv={kv_name} graph:"
    chunk, sp = GRAPH_CHUNK, SamplingParams()
    ids = word_ids(eng.max_seq - 2 * chunk - GRAPH_TAIL)
    eng.reset()
    ref = [int(np.argmax(eng.prefill(ids)))]
    while eng.n_past < eng.max_seq:
        ref.append(int(np.argmax(eng.decode_step(ref[-1]))))
    count(len(ids), len(ref) - 1)
    eng.reset()
    got = eng.generate_tokens_device(ids, 10 ** 6, stop_on_eog=False, chunk=chunk, to_end=True)
    count(len(ids), len(got) - 1)
    runner = eng.decode_runner(sp, chunk)
    log(f"{tag} {len(got) - 1} decode steps from a {len(ids)}-token prompt to n_past = "
        f"{eng.n_past} ({runner.replays} replays so far): ids "
        f"{'equal to' if got == ref else 'DIFFERENT from'} the decode_step loop's")
    expect(len(got) - 1 == 2 * chunk + GRAPH_TAIL and eng.n_past == eng.max_seq,
           f"{label}: two chunks and a tail of {GRAPH_TAIL}")
    expect(got == ref, f"{label}: graph ids equal the decode_step loop's (first difference "
           f"at {next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)})")

    per = per_forward_launches(eng.params)
    one = runner.launches_per_replay()
    want = {"qmm": per["qmm"], "qmm_tc": 0, "qmm_stack": 0, "qmm_gather": per["experts"],
            "qmm_grouped": 0, "dequant_routes": 0, "flash": per["flash"],
            "flash_decode": per["flash"], "attn_dense_routes": 0}
    log(f"{tag} launches per replay (one token) {one}; capture {runner.capture_s:.3f} s, "
        f"graph pool {runner.pool_bytes / 2**20:.1f} MiB")
    expect(one == want, f"{label}: launches per replay {one} = per forward {want}")

    prompt = word_ids(10)
    walls = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        runs = 1 if mode == "eager" else 2
        walls[mode].append(time_runs(eng, runner, prompt, runs, eager=mode == "eager"))
        count(len(prompt), runs * chunk)
    e_prof = profile_decode(eng, runner, prompt, EAGER_PROFILE_STEPS, eager=True)
    count(len(prompt), EAGER_PROFILE_STEPS)
    out = dict(ids_equal=got == ref, decode_steps=len(got) - 1, launches_per_replay=one,
               capture_s=runner.capture_s, pool_bytes=runner.pool_bytes,
               eager_wall_ms=walls["eager"], graph_wall_ms=walls["graph"],
               graph=_decode_summary(graph_prof, float(np.mean(walls["graph"]))),
               eager=_decode_summary(e_prof, float(np.mean(walls["eager"]))))
    for mode in ("eager", "graph"):
        r = out[mode]
        log(f"{tag} {mode}: wall {r['wall_ms']:.3f} ms a token ({r['tok_s']:.2f} tok/s; turns "
            f"{', '.join(f'{w:.3f}' for w in walls[mode])}), busy {r['busy_ms']:.3f} ms "
            f"({r['busy_from']}; event span {r['event_span_ms_per_token']:.3f}), idle "
            f"{r['idle_share']:.3f}; by family "
            f"{ {k: round(v, 4) for k, v in r['device_ms_per_token'].items()} }")

    sampled = []
    for _ in range(2):
        eng.reset()
        n0 = eng.perf.n_decode
        sampled.append(eng.generate_tokens_device(prompt, 48, temp=0.8, seed=11,
                                                  stop_on_eog=False, chunk=chunk))
        count(len(prompt), eng.perf.n_decode - n0)
    log(f"{tag} temp 0.8, seed 11, two runs: {sampled[0][:12]}… "
        f"{'the same' if sampled[0] == sampled[1] else 'DIFFERENT'}")
    expect(sampled[0] == sampled[1] and len(sampled[0]) == 48,
           f"{label}: sampled graph runs from one seed agree")
    out["sampled_equal"] = True
    return out


def synthesize(tmp: Path, label: str, shape: str, ftype: str, n_layer: int | None = None,
               vocab: str = "spm") -> Path:
    """A synthetic GGUF of `shape` at preset `ftype` in `tmp`, after a check
    that the disk holds it with 2 GB to spare."""
    from tpullm_torch.models.synth import synthetic_writer

    path = tmp / f"{shape}-{ftype.lower()}{f'-{n_layer}l' if n_layer else ''}-{vocab}.gguf"
    writer = synthetic_writer(path, shape=shape, seed=0, ftype=ftype, n_layer=n_layer,
                              vocab=vocab)
    need, free = writer.payload_bytes(), shutil.disk_usage(tmp).free
    expect(free > need + 2e9, f"{free / 1e9:.1f} GB free in {tmp} holds the "
           f"{need / 1e9:.1f} GB {shape} {ftype} GGUF with 2 GB to spare")
    t0 = time.perf_counter()
    writer.write()
    log(f"[{label}] synthesized {path.stat().st_size / 2**30:.2f} GiB {shape} {ftype}"
        f"{f' ({n_layer} layers)' if n_layer else ''} GGUF ({vocab} vocab) in "
        f"{time.perf_counter() - t0:.1f}s")
    return path


# mixed scripts, digits, contractions and a special token, for the BPE vocab
MIXED_SENTENCE = ("Hello, wörld! It's 12345 naïve 漢字とカタカナ, русский текст, ١٢٣ "
                  "— done.<|eot_id|>\n")


def bpe_round_trip(path):
    """The 8B's byte-level BPE vocab as a Llama-3 GGUF carries it, and
    MIXED_SENTENCE through the port's tokenizer and back."""
    from tpullm_torch.gguf.reader import GGUFReader
    from tpullm_torch.tokenizer import BPETokenizer, from_gguf

    t0 = time.perf_counter()
    tok = from_gguf(GGUFReader(path))
    v = tok.vocab
    ids = tok.tokenize(MIXED_SENTENCE, add_special=True, parse_special=True)
    back = tok.detokenize(ids, remove_special=True, unparse_special=True)
    log(f"[slice] vocab: model {v.model!r}, pre {v.pre!r}, {v.n_tokens} tokens, "
        f"{len(v.merges)} merges, bos {v.special.bos}, eot {v.special.eot}; "
        f"{MIXED_SENTENCE!r} → {len(ids)} ids {ids} → {back!r} "
        f"({'round trip exact' if back == MIXED_SENTENCE else 'ROUND TRIP DIFFERS'}; "
        f"{time.perf_counter() - t0:.1f}s)")
    expect(isinstance(tok, BPETokenizer) and (v.model, v.pre) == ("gpt2", "llama-bpe")
           and v.n_tokens == 128256, "the 8B carries a gpt2 / llama-bpe vocab of 128256")
    expect(ids[0] == v.special.bos and ids[-2] == v.special.eot, "bos first, <|eot_id|> parsed")
    expect(back == MIXED_SENTENCE, "the mixed-script sentence round-trips")


def phase_slice(tmp: Path, launches: dict) -> list[dict]:
    """Llama-3-8B Q4_K_M on Llama-3's byte-level BPE vocab, with a bf16 and
    a q8 KV cache, each with the graph phase; the file is deleted after, to
    leave the disk to the next model."""
    import torch

    path = synthesize(tmp, "slice", "llama-3-8b", "Q4_K_M", vocab="bpe")
    bpe_round_trip(path)
    runs = [serve("slice", path, kv, launches, graph=True) for kv in (torch.bfloat16, "q8_0")]
    path.unlink()
    return runs


def phase_presets(tmp: Path, launches: dict) -> list[dict]:
    """Llama-3-8B with 4 layers (one prompt, 16 decode steps) at Q2_K (a
    bf16 and a q8 KV cache), IQ4_XS, Q4_0, Q4_1, Q5_0, Q5_1, IQ4_NL and
    Q3_K_M; Mixtral-8x7B at MXFP4_MOE with 4 layers, a 64-token prompt (the
    all-experts regime) and its decode (gather)."""
    import torch

    runs = []
    path = synthesize(tmp, "8b-Q2_K", "llama-3-8b", "Q2_K", n_layer=4)
    runs += [serve("8b-Q2_K", path, kv, launches, short=64) for kv in (torch.bfloat16, "q8_0")]
    path.unlink()
    for ftype in ("IQ4_XS", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "IQ4_NL", "Q3_K_M"):
        path = synthesize(tmp, f"8b-{ftype}", "llama-3-8b", ftype, n_layer=4)
        runs.append(serve(f"8b-{ftype}", path, torch.bfloat16, launches, short=64))
        path.unlink()
    path = synthesize(tmp, "mixtral-MXFP4_MOE", "mixtral-8x7b", "MXFP4_MOE", n_layer=4)
    run = serve("mixtral-MXFP4_MOE", path, torch.bfloat16, launches, short=64)
    expect(run["launches"].get("qmm_stack.MXFP4", 0) > 0
           and run["launches"].get("qmm_gather.MXFP4", 0) > 0 and run["launches"]["qmm_q8_0"] > 0,
           "mixtral MXFP4_MOE ran MXFP4 through qmm_stack and qmm_gather, Q8_0 through qmm")
    runs.append(run)
    path.unlink()
    return runs


def phase_iquants(tmp: Path, launches: dict) -> list[dict]:
    """Llama-3-8B at IQ1_S and IQ3_XXS at full depth (32 tokens a prompt;
    between them IQ1_S, IQ2_XXS, IQ2_S, IQ3_XXS and an IQ3_S embedding); at
    IQ2_XXS, IQ2_XS, IQ2_M, IQ1_M, IQ3_M, TQ1_0 and TQ2_0 with 4 layers (one
    prompt, 16 decode steps); Mixtral-8x7B at IQ2_XXS with 4 layers (a
    64-token prompt through qmm_stack, decode through qmm_gather); the 8B at
    Q4_K_M with 4 layers and qmm.GROUPED_TYPES = {Q4_K, Q6_K}: every 2-D
    launch goes through qmm_grouped."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops.kernels import qmm

    runs = []
    for ftype in ("IQ1_S", "IQ3_XXS"):
        path = synthesize(tmp, f"8b-{ftype}", "llama-3-8b", ftype)
        runs.append(serve(f"8b-{ftype}", path, torch.bfloat16, launches, n_gen=32))
        path.unlink()
    for ftype in ("IQ2_XXS", "IQ2_XS", "IQ2_M", "IQ1_M", "IQ3_M", "TQ1_0", "TQ2_0"):
        path = synthesize(tmp, f"8b-{ftype}", "llama-3-8b", ftype, n_layer=4)
        runs.append(serve(f"8b-{ftype}", path, torch.bfloat16, launches, short=64))
        path.unlink()
    path = synthesize(tmp, "mixtral-IQ2_XXS", "mixtral-8x7b", "IQ2_XXS", n_layer=4)
    run = serve("mixtral-IQ2_XXS", path, torch.bfloat16, launches, short=64)
    expect(run["launches"].get("qmm_stack.IQ2_XXS", 0) > 0
           and run["launches"].get("qmm_gather.IQ2_XXS", 0) > 0
           and run["launches"]["qmm_iq2_xxs"] > 0,
           "mixtral IQ2_XXS ran IQ2_XXS through qmm_stack, qmm_gather and qmm")
    runs.append(run)
    path.unlink()
    path = synthesize(tmp, "8b-grouped", "llama-3-8b", "Q4_K_M", n_layer=4)
    expect(not qmm.GROUPED_TYPES, "qmm.GROUPED_TYPES is empty (TPULLM_QMM_GROUPED unset)")
    qmm.GROUPED_TYPES.update({GGMLType.Q4_K, GGMLType.Q6_K})
    try:
        run = serve("8b-Q4_K_M-grouped", path, torch.bfloat16, launches, short=64,
                    prefill_len=512)
    finally:
        qmm.GROUPED_TYPES.clear()
    expect(run["launches"]["qmm_grouped"] > 0 and run["launches"]["qmm_tc"] == 0
           and sum(run["launches"][k] for k in QMM_KEYS.values()) == 0,
           "the grouped run's 2-D launches all went through qmm_grouped")
    # the 512-token prefill's 2-D qmm kernels by name: each layer's linears
    # on the grouped tensor-core kernel, the head (its last row only) on the
    # gemv body, and no other
    per = run["per_forward"]
    two_d = {k: n for k, n in run["prefill_profile"]["launches"].items()
             if k not in REDUCTION_KERNELS and not k.startswith(("qmm_stack", "qmm_gather", "flash"))}
    want = {"qmm_grouped_tc_kernel": per["qmm_layers"], "qmm_grouped_gemv_kernel": per["head"]}
    expect(two_d == want, f"the grouped run's 512-token prefill ran the 2-D kernels {two_d}, "
           f"not {want}")
    runs.append(run)
    path.unlink()
    return runs


def phase_mixtral(tmp: Path, launches: dict) -> dict:
    """Mixtral-8x7B Q4_K_M (the 8-expert recipe) at full width and depth,
    with a bf16 KV cache."""
    import torch

    path = synthesize(tmp, "mixtral", "mixtral-8x7b", "Q4_K_M")
    run = serve("mixtral", path, torch.bfloat16, launches, graph=True)
    expect(run["launches"]["qmm_stack"] > 0 and run["launches"]["qmm_gather"] > 0
           and run["launches"]["qmm_q5k"] > 0 and run["launches"]["qmm_q8_0"] > 0,
           "mixtral ran the stack, gather, Q5_K and Q8_0 kernels")
    path.unlink()
    return run


def phase_routes(dev, tmp: Path):
    """The shapes the kernels do not take, on the card: the tiny model with
    a 250-token Q6_K head (N % 4 != 0) against the same model on the CPU,
    every head call through the dequantize-then-matmul route; one
    attention_cached call at head dim 96 through the dense path, against
    attention_reference."""
    import torch

    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.ops import attention
    from tpullm_torch.ops.kernels import flash, qmm
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import KVCache

    path = make_synthetic_llama_gguf(tmp / "tiny-v250.gguf", shape="tiny", seed=0, n_vocab=250)
    gpu = Engine(path, max_seq=256)
    cpu = Engine(path, device="cpu", max_seq=256)
    ids = gpu.tokenizer.tokenize("hello world the quick brown fox")
    reset_launches()
    errs = [nmse(torch.from_numpy(gpu.prefill(ids)), torch.from_numpy(cpu.prefill(ids)))]
    for tok in (100, 17, 42, 249, 5):
        errs.append(nmse(torch.from_numpy(gpu.decode_step(tok)),
                         torch.from_numpy(cpu.decode_step(tok))))
    gpu.reset()
    cpu.reset()
    a = gpu.generate_tokens_device(ids, 16, chunk=8)
    b = cpu.generate_tokens_device(ids, 16, chunk=8)
    torch.cuda.synchronize()
    forwards = 2 + gpu.perf.n_decode  # two prefills; the decode steps and generated ids
    got = read_launches()
    log(f"[routes] tiny, 250-token head: logits NMSE card vs cpu max {max(errs):.2e}; greedy "
        f"{'equal' if a == b else 'DIFFERENT'}; {forwards} forwards, dequantize route "
        f"{dict((k, v) for k, v in qmm.DEQUANT_ROUTES.items() if v)}, launches {got}")
    expect(max(errs) <= 1e-3, f"250-token head: logits NMSE {max(errs):.3e} <= 1e-3")
    expect(a == b, f"250-token head: greedy ids card {a} vs cpu {b}")
    expect(qmm.DEQUANT_ROUTES["Q6_K"] == got["dequant_routes"] == forwards,
           f"250-token head: {got['dequant_routes']} dequantize-route calls = {forwards} heads")
    expect(got["attn_dense_routes"] == 0, "250-token head: attention on the kernel")

    reset_launches()
    g = torch.Generator(dev).manual_seed(5)
    B, T, H, Hkv, S, D = 1, 24, 8, 2, 96, 96
    cache = KVCache(torch.randn(1, B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16),
                    torch.randn(1, B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16))
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
    off = torch.tensor([40], dtype=torch.int32, device=dev)
    out = attention.attention_cached(q, cache, 0, D ** -0.5, off)
    pos = 40 + torch.arange(T, device=dev)[None]
    ref = attention.attention_reference(q, cache.k[0], cache.v[0],
                                        attention.causal_mask(pos, S, 40 + T), D ** -0.5)
    err = nmse(out.float(), flash.flash_reference(q, cache.k[0], cache.v[0], off,
                                                  D ** -0.5).float())
    log(f"[routes] attention at head dim 96: dense route calls {dict(flash.ATTN_DENSE_ROUTES)}, "
        f"flash launches {dict(flash.LAUNCHES)}; NMSE against the flash plain version {err:.2e}")
    expect(nmse(out.float(), ref.float()) <= 1e-10,
           "head dim 96: the dense path is attention_reference")
    expect(flash.ATTN_DENSE_ROUTES["bf16"] == 1 and sum(flash.LAUNCHES.values()) == 0,
           "head dim 96: one counted dense-route call, no flash launch")
    expect(err <= FLASH_NMSE_BOUND, f"head dim 96: NMSE {err:.3e} <= {FLASH_NMSE_BOUND}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "tpullm_torch" / "csrc").is_dir():
        print(f"chip_smoke: tpullm_torch is not beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f}s")
        return out

    smi = timed("card", phase_card)
    timed("build", phase_build)
    results: dict = {}
    timed("qmm", phase_qmm, dev, results)
    timed("grouped", phase_grouped, dev, results)
    timed("moe kernels", phase_moe_kernels, dev, results)
    timed("flash", phase_flash, dev, results)
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="tpullm_torch_smoke_") as tmp:
        timed("tiny", phase_tiny, dev, Path(tmp))
        runs = timed("slice", phase_slice, Path(tmp), launches)
        runs += timed("presets", phase_presets, Path(tmp), launches)
        runs += timed("i-quants", phase_iquants, Path(tmp), launches)
        runs.append(timed("mixtral", phase_mixtral, Path(tmp), launches))
        timed("routes", phase_routes, dev, Path(tmp))
    log("[runs] summary " + json.dumps({"runs": runs}))
    grouped_prefill_launches = next(r["prefill_profile"]["launches"] for r in runs
                                    if r["model"] == "8b-Q4_K_M-grouped")

    kernels = []
    for key in KERNELS:
        rows = results[key]
        rep = next(r for r in rows if r["case"] == REPRESENTATIVE[key])
        entry = dict(
            name=key, route="cuda", source=SOURCES[key], replaces=REPLACES[key],
            launches=launches[key], max_abs_err=max(r["max_abs_err"] for r in rows),
            max_nmse=max(r["nmse"] for r in rows), case=rep["case"], ms=rep["ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"])
        if key == "qmm_grouped":
            entry["bodies"] = {"M < 16": "qmm_grouped_gemv_kernel (csrc/qmm_gemv.cuh)",
                               "M >= 16": "qmm_grouped_tc_kernel (csrc/qmm_tc.cuh)"}
            entry["qmm_ms_same_planes"] = rep["qmm_ms"]
            entry["grouped_run_prefill_launches"] = grouped_prefill_launches
            for r in rows:  # the gemv body at M = 8, the tensor-core body from 16
                if r["case"].startswith("Q4_K") and r["case"] != rep["case"]:
                    m = r["case"].split("M=")[1]
                    tag = f"m{m}" if " gate_up " in r["case"] else f"down_m{m}"
                    entry.update({f"{tag}_ms": r["ms"], f"{tag}_qmm_ms": r["qmm_ms"],
                                  f"{tag}_bound_ms": r["bound_ms"],
                                  f"{tag}_library_ms": r["library_ms"],
                                  f"{tag}_split": r["split"]})
        if key == "qmm_gather":
            for r in rows:
                if r["case"].startswith("Q4_K gate T=32"):
                    tag = "t32_one_expert" if "one expert" in r["case"] else "t32"
                    entry.update({f"{tag}_ms": r["ms"], f"{tag}_bound_ms": r["bound_ms"],
                                  f"{tag}_library_ms": r["library_ms"]})
        if key == "qmm_tc":
            entry["cuda_core_ms_same_planes"] = rep["cuda_core_ms"]
            entry["formats_held"] = sorted({r["case"].split()[0] for r in rows})
        if key in ("qmm_tc", "qmm_grouped"):
            entry["launches_by_format"] = {k.split(".")[1]: v for k, v in launches.items()
                                           if k.startswith(key + ".")}
        if key in ("qmm_stack", "qmm_gather"):
            entry["formats_held"] = sorted({r["case"].split()[0] for r in rows})
            entry["launches_by_format"] = {k.split(".")[1]: v for k, v in launches.items()
                                           if k.startswith(key + ".")}
        if "cold_ms" in rep:
            entry["cold_ms"] = rep["cold_ms"]
        if key.startswith("flash"):
            # the representative is the decode regime (T = 1); the decode
            # regime at short contexts and the prefill regime beside it
            for r in rows:
                if " B=1 kv=" in r["case"]:
                    kv = r["case"].split("kv=")[1].split()[0]
                    entry.update({f"kv{kv}_ms": r["ms"], f"kv{kv}_bound_ms": r["bound_ms"],
                                  f"kv{kv}_library_ms": r["library_ms"]})
            pre = next(r for r in rows if r["case"].endswith("T=512 S=4096"))
            entry.update(prefill_case=pre["case"], prefill_ms=pre["ms"],
                         prefill_plain_ms=pre["plain_ms"], prefill_bound_ms=pre["bound_ms"],
                         prefill_bound_by=pre["bound_by"], prefill_library_ms=pre["library_ms"],
                         prefill_p_terms1_nmse=pre["p_terms1_nmse"],
                         prefill_p_terms2_nmse=pre["p_terms2_nmse"],
                         launches_decode=launches[key + ".decode"],
                         launches_prefill=launches[key] - launches[key + ".decode"])
            expect(entry["launches_decode"] > 0 and entry["launches_prefill"] > 0,
                   f"{key} launched in both regimes on the main path")
        if key == "qmm_mxfp4":
            # MXFP4 is an expert format only: its main-path launches go through
            # the stack and gather entries of the same device body
            entry["launches_2d"] = launches[key]
            entry["launched_through"] = ["qmm_stack", "qmm_gather"]
            entry["launches"] = (launches.get("qmm_stack.MXFP4", 0)
                                 + launches.get("qmm_gather.MXFP4", 0))
        expect(entry["launches"] > 0, f"{key} launched on the main path")
        kernels.append(entry)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
