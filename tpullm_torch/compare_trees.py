"""Times two checkouts of the port on one card, in turn, with one yardstick.

    python3 tpullm_torch/compare_trees.py --parent DIR [--rounds N] [--out FILE] [--no-decode]

DIR is another checkout of the repository (for example the parent commit,
unpacked with `git archive` into a directory that .gitignore lists). The
script runs the parent, this checkout, this checkout again and the parent
again (N rounds of parent and this checkout, alternating which goes first;
default 2), each in a process of its own that imports `tpullm_torch` from its
checkout and builds that checkout's kernels, and measures in each, with the
timing code of this file:
- flash at T = 1 (H = 32, Hkv = 8, D = 128, S = 4096: the 8B's decode) in
  both cache formats, at kv_len 38 and 3001 in one call (B = 2) and at
  B = 1 with kv_len 20, 100 and 512; qmm at M = 1 on the 8B's gate_up,
  down and wo for a few formats; qmm_grouped (the group-factored kernel)
  at M = 1 on the 8B's gate_up for the same formats; qmm_gather on
  Mixtral's expert stacks (8 experts, gate 4096→14336 and down
  14336→4096) at Q4_K and Q6_K, T = 2 (a decode token's two experts) and
  T = 32 (the 16-token bucket, a repeated expert). Each as the device time of a CUDA-graph
  replay of back-to-back calls, as the time of the same calls launched
  eagerly back to back, and as the host's time to issue one call (the
  calls issued without waiting, over their count: the wrapper's dispatch);
  flash at B = 1 also cold (each call after 64 MB of writes, which evict
  the L2; the writes' own time subtracted);
- the prefill kernels as graph-replay device time only: qmm (the
  tensor-core regime) and qmm_grouped at M = 16 and 512 on the 8B's
  gate_up for all 22 formats, qmm_stack at M = 512 on Mixtral's gate (8
  experts, shared x) at Q4_K and Q6_K, flash at T = 512 (S = 4096, both
  cache formats); and each tensor-core kernel's registers and spill bytes
  from the tree's build report;
- one profiled 512-token prefill of a Llama-3-8B Q4_K_M with 4 layers
  (synthesized once by this checkout) with Q4_K and Q6_K in
  qmm.GROUPED_TYPES, device ms by kernel family and launches by kernel
  name;
- unless --no-decode: the decode rate of a Llama-3-8B Q4_K_M (random
  weights from seed 0, synthesized once by this checkout) with a bf16
  cache: 3 × 64 greedy tokens after "hello world", and the launches of the
  flash and qmm wrappers a decode token.
It prints the card's name and power limit, each run's numbers and a table
of the parent's and this checkout's means, and writes every number as JSON
to FILE (default chiprun_out/compare_trees.json). Needs one CUDA card and
nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLASH_CASES = (("B=2 kv 38/3001", (37, 3000)), ("B=1 kv 20", (19,)), ("B=1 kv 100", (99,)),
               ("B=1 kv 512", (511,)))
QMM_CASES = (("Q4_K", "gate_up", 4096, 28672), ("Q6_K", "gate_up", 4096, 28672),
             ("Q8_0", "gate_up", 4096, 28672), ("Q4_0", "gate_up", 4096, 28672),
             ("Q4_K", "down", 14336, 4096), ("Q4_K", "wo", 4096, 4096))
GATHER_CASES = (("Q4_K", "gate", 4096, 14336), ("Q4_K", "down", 14336, 4096),
                ("Q6_K", "gate", 4096, 14336), ("Q6_K", "down", 14336, 4096))
PREFILL_FORMATS = ("Q4_K", "Q6_K", "Q5_K", "Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "MXFP4",
                   "IQ4_NL", "Q2_K", "Q3_K", "IQ4_XS", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS",
                   "IQ3_S", "IQ1_S", "IQ1_M", "TQ1_0", "TQ2_0")
PREFILL_ROWS = (16, 512)
TC_KERNELS = ("qmm_tc_kernel", "qmm_stack_kernel", "qmm_grouped_tc_kernel")
N_EXPERT = 8
ITERS = 50


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _timers(torch):
    stream = torch.cuda.Stream()

    def events(run) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def graph_ms(fn) -> float:
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # warm up on the capture stream
            for _ in range(2):
                fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            for _ in range(ITERS):
                fn()
        g.replay()
        torch.cuda.synchronize()
        ms = events(g.replay) / ITERS
        del g
        return ms

    def eager_ms(fn) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        return events(lambda: [fn() for _ in range(ITERS)]) / ITERS

    def host_us(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / ITERS * 1e6

    return graph_ms, eager_ms, host_us


def _record(out: dict, key: str, timer, fn, less: float = 0.0) -> None:
    try:
        out[key] = timer(fn) - less
    except Exception as e:  # a tree whose wrapper cannot be captured: recorded, not fatal
        out[key] = f"failed: {type(e).__name__}: {e}"[:200]


def _measure(fn, timers, out: dict, key: str) -> None:
    for name, timer in zip(("graph_ms", "eager_ms", "host_us"), timers):
        _record(out, f"{key} {name}", timer, fn)


def _smoke():
    """This checkout's chip_smoke.py as a module (its parsers and profilers
    serve both trees)."""
    import importlib.util

    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
        sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["chip_smoke"])
    return sys.modules["chip_smoke"]


def _registers(reports: dict) -> dict:
    """{kernel<F>: [registers, spill store bytes, spill load bytes]} of the
    tensor-core kernels in a build's `-Xptxas -v` reports (parsed by
    chip_smoke.ptxas_entries)."""
    return {k: [r, st, ld] for rep, _ in reports.values()
            for k, r, st, ld in _smoke().ptxas_entries(rep) if k.startswith(TC_KERNELS)}


def _grouped_prefill(gguf: str) -> dict:
    """One profiled 512-token prefill with Q4_K and Q6_K in GROUPED_TYPES
    (after a warm-up prefill), by chip_smoke.profile_prefill: device ms by
    kernel family, launches by kernel name."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops.kernels import qmm
    from tpullm_torch.runtime.engine import Engine

    qmm.GROUPED_TYPES.update({GGMLType.Q4_K, GGMLType.Q6_K})
    try:
        eng = Engine(gguf, max_seq=4096, kv_dtype=torch.bfloat16)
        words = "the quick brown fox jumps over the lazy dog hello world".split()
        ids = [1] + [eng.tokenizer.vocab.token_to_id["▁" + words[i % len(words)]]
                     for i in range(511)]
        eng.prefill(ids)
        prof = _smoke().profile_prefill(eng, ids)
    finally:
        qmm.GROUPED_TYPES.clear()
    del eng
    return {**prof, "busy_ms": sum(prof["device_ms"].values())}


def worker(tree: Path, gguf: str | None, grouped_gguf: str) -> dict:
    sys.path[0] = str(tree)  # this checkout's tpullm_torch, not the script's
    import numpy as np
    import torch

    from tpullm_torch.gguf.constants import TYPE_TRAITS, GGMLType
    from tpullm_torch.models.synth import write_scales
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import _build, flash, qmm
    from tpullm_torch.runtime.kvcache import QuantKVCache

    assert Path(flash.__file__).resolve().is_relative_to(tree.resolve()), flash.__file__
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    reports = _build.build()
    res: dict = {"tree": str(tree), "build_s": time.perf_counter() - t0,
                 "registers": _registers(reports)}
    timers = _timers(torch)
    gen = torch.Generator(dev).manual_seed(0)
    H, Hkv, D, S = 32, 8, 128, 4096
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)  # 64 MB
    flush_ms = timers[0](flush.zero_)
    for label, offsets in FLASH_CASES:
        B = len(offsets)
        q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        k_q, k_s = QuantKVCache._quantize(k)
        v_q, v_s = QuantKVCache._quantize(v)
        fns = {"bf16": lambda: flash.flash_attention(q, k, v, off, D ** -0.5),
               "q8": lambda: flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, D ** -0.5)}
        for fmt, fn in fns.items():
            ref = flash.flash_reference(q, *((k, v) if fmt == "bf16" else (k_q, v_q)), off,
                                        D ** -0.5, **({} if fmt == "bf16" else
                                                      dict(k_scale=k_s, v_scale=v_s)))
            err = float((fn().float() - ref.float()).abs().max())
            assert err < 0.05, f"flash {fmt} {label}: max |d| {err}"
            _measure(fn, timers, res, f"flash {fmt} {label}")
            if B == 1:
                _record(res, f"flash {fmt} {label} cold_ms", timers[0],
                        lambda: (flush.zero_(), fn()), flush_ms)
        del q, k, v, k_q, v_q
    def random_planes(gtype, N, K):
        tt = TYPE_TRAITS[gtype]
        nb = N * K // tt.block_size
        raw = torch.randint(0, 256, (nb, tt.type_size), generator=gen, device=dev,
                            dtype=torch.uint8)
        write_scales(raw, gtype, (torch.rand(nb, generator=gen, device=dev) + 0.5) * 0.02)
        return qmatmul.repack(raw.reshape(-1), gtype, N, K, dev)

    def check(got, ref, what):
        got, ref = got.float(), ref.float()
        nmse = float(((got - ref) ** 2).mean() / (ref ** 2).mean())
        assert nmse < 5e-4, f"{what}: NMSE {nmse}"

    for fmt, name, K, N in QMM_CASES:
        gtype = GGMLType[fmt]
        planes = random_planes(gtype, N, K)
        x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
        check(qmm.qmm(x, planes, gtype, N, K), qmm.qmm_reference(x, planes, gtype, N, K),
              f"qmm {fmt} {name}")
        _measure(lambda: qmm.qmm(x, planes, gtype, N, K), timers, res, f"qmm {fmt} {name} M=1")
        if name == "gate_up":
            check(qmm.qmm_grouped(x, planes, gtype, N, K),
                  qmm.qmm_grouped_reference(x, planes, gtype, N, K), f"qmm_grouped {fmt}")
            _measure(lambda: qmm.qmm_grouped(x, planes, gtype, N, K), timers, res,
                     f"qmm_grouped {fmt} {name} M=1")
        del planes
    for fmt, name, K, N in GATHER_CASES:
        gtype = GGMLType[fmt]
        per = [random_planes(gtype, N, K) for _ in range(N_EXPERT)]
        stack = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        del per
        for T in (2, 32):
            x = torch.randn(T, K, generator=gen, device=dev).to(torch.bfloat16)
            if T == 2:
                ids = torch.randperm(N_EXPERT, generator=gen, device=dev)[:2].int()
            else:
                ids = torch.randint(0, N_EXPERT, (T,), generator=gen, device=dev,
                                    dtype=torch.int32)
                ids[-1] = ids[0]
            check(qmm.qmm_gather(x, ids, stack, gtype, N, K),
                  qmm.qmm_gather_reference(x, ids, stack, gtype, N, K), f"qmm_gather {fmt} {name}")
            _measure(lambda: qmm.qmm_gather(x, ids, stack, gtype, N, K), timers, res,
                     f"qmm_gather {fmt} {name} T={T}")
        del stack
    for fmt in PREFILL_FORMATS:
        gtype, (name, K, N) = GGMLType[fmt], ("gate_up", 4096, 28672)
        planes = random_planes(gtype, N, K)
        for M in PREFILL_ROWS:
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            check(qmm.qmm_grouped(x, planes, gtype, N, K),
                  qmm.qmm_grouped_reference(x, planes, gtype, N, K), f"qmm_grouped {fmt} M={M}")
            for kind, fn in (("qmm", qmm.qmm), ("qmm_grouped", qmm.qmm_grouped)):
                _record(res, f"{kind} {fmt} {name} M={M} graph_ms", timers[0],
                        lambda: fn(x, planes, gtype, N, K))
        del planes
    for fmt in ("Q4_K", "Q6_K"):
        gtype, K, N = GGMLType[fmt], 4096, 14336
        per = [random_planes(gtype, N, K) for _ in range(N_EXPERT)]
        stack = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        del per
        x = torch.randn(512, K, generator=gen, device=dev).to(torch.bfloat16)
        _record(res, f"qmm_stack {fmt} gate M=512 graph_ms", timers[0],
                lambda: qmm.qmm_stack(x, stack, gtype, N, K))
        del stack
    T = 512
    q = torch.randn(1, T, H, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(1, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(1, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
    off = torch.tensor([2500], dtype=torch.int32, device=dev)
    k_q, k_s = QuantKVCache._quantize(k)
    v_q, v_s = QuantKVCache._quantize(v)
    _record(res, "flash bf16 T=512 graph_ms", timers[0],
            lambda: flash.flash_attention(q, k, v, off, D ** -0.5))
    _record(res, "flash q8 T=512 graph_ms", timers[0],
            lambda: flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, D ** -0.5))
    del q, k, v, k_q, v_q
    torch.cuda.empty_cache()
    gp = res["grouped prefill 512"] = _grouped_prefill(grouped_gguf)
    res["grouped prefill 512 busy_ms"] = gp["busy_ms"]
    res["grouped prefill 512 qmm_grouped_ms"] = gp["device_ms"]["qmm_grouped"]
    torch.cuda.empty_cache()
    if gguf:
        from tpullm_torch.runtime.engine import Engine

        eng = Engine(gguf, max_seq=4096, kv_dtype=torch.bfloat16)
        ids = eng.tokenizer.tokenize("hello world")
        eng.generate_tokens_device(ids, 8, temp=0.0, stop_on_eog=False)
        rates, outs = [], []
        for _ in range(3):
            eng.reset()
            f0, q0 = sum(flash.LAUNCHES.values()), sum(qmm.LAUNCHES.values())
            p0 = (eng.perf.t_decode_s, eng.perf.n_decode)
            outs.append(eng.generate_tokens_device(ids, 64, temp=0.0, stop_on_eog=False,
                                                   chunk=32))
            n = eng.perf.n_decode - p0[1]
            rates.append(n / (eng.perf.t_decode_s - p0[0]))
        res["decode tok/s"] = rates
        res["decode ms a token (median)"] = 1e3 / float(np.median(rates))
        res["flash launches a generation"] = sum(flash.LAUNCHES.values()) - f0
        res["qmm launches a generation"] = sum(qmm.LAUNCHES.values()) - q0
        res["decode steps a generation"] = n
        res["greedy ids"] = outs[0][:16]
        del eng
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "compare_trees.json")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--no-decode", action="store_true")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--gguf", help=argparse.SUPPRESS)
    ap.add_argument("--grouped-gguf", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.gguf, args.grouped_gguf)))
        return 0
    if args.parent is None or not (args.parent / "tpullm_torch").is_dir():
        ap.error("--parent must be a checkout holding tpullm_torch/")
    sys.path[0] = str(ROOT)  # the repository, not this file's directory
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        from tpullm_torch.models.synth import synthetic_writer

        gguf = None
        if not args.no_decode:
            gguf = Path(tmp) / "llama-3-8b-q4_k_m.gguf"
            t0 = time.perf_counter()
            synthetic_writer(gguf, shape="llama-3-8b", seed=0, ftype="Q4_K_M").write()
            print(f"synthesized the 8B Q4_K_M in {time.perf_counter() - t0:.1f}s", flush=True)
        grouped_gguf = Path(tmp) / "llama-3-8b-q4_k_m-4l.gguf"
        synthetic_writer(grouped_gguf, shape="llama-3-8b", seed=0, ftype="Q4_K_M",
                         n_layer=4).write()
        runs = []
        pair = (("parent", args.parent), ("change", ROOT))
        for name, tree in [run for i in range(args.rounds) for run in pair[::1 - 2 * (i % 2)]]:
            cmd = [sys.executable, __file__, "--worker", str(tree.resolve())]
            t0 = time.perf_counter()
            cmd += ["--grouped-gguf", str(grouped_gguf)] + (["--gguf", str(gguf)] if gguf else [])
            proc = subprocess.run(cmd, cwd=tree,
                                  stdout=subprocess.PIPE, text=True, env=dict(os.environ))
            if proc.returncode != 0:
                print(f"{name} run failed (exit {proc.returncode})", flush=True)
                return 1
            runs.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
            print(f"{name} run {len(runs)}: {time.perf_counter() - t0:.1f}s", flush=True)
    keys = [k for k in runs[1][1] if k not in ("tree",)]
    table = {}
    for key in keys:
        vals = {n: [r.get(key) for m, r in runs if m == n] for n in ("parent", "change")}
        table[key] = vals
        if any(isinstance(v, dict) for vs in vals.values() for v in vs):
            continue  # registers, profiles: in the JSON only
        nums = {n: [v for v in vs if isinstance(v, (int, float))] for n, vs in vals.items()}
        mean = {n: (sum(v) / len(v) if v and len(v) == len(vals[n]) else None)
                for n, v in nums.items()}
        print(f"{key}: parent {vals['parent']} change {vals['change']}"
              + (f" -> means {mean['parent']:.5g} / {mean['change']:.5g}"
                 if None not in mean.values() else ""), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "order": [n for n, _ in runs],
                                    "runs": [r for _, r in runs], "table": table}, indent=1))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
