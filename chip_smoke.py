#!/usr/bin/env python3
"""Smoke run of tpullm_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits nonzero:
 1. card: name and power limit (nvidia-smi), torch and CUDA versions;
 2. build: compiles every kernel from tpullm_torch/csrc with nvcc, one
    process per source, and prints the `-Xptxas -v` report;
 3. kernels vs plain: each kernel against its plain PyTorch version on the
    card at the Llama-3-8B shapes of the main path (qmm: Q4_K and Q6_K,
    M in {1, 512}; flash: bf16 and q8 KV, T in {1, 512}, S = 4096, GQA
    32/8) plus small softcap / window / sink / ALiBi cases, held to the NMSE
    bounds of the JAX package's conformance sweep; each timed with CUDA
    events beside its bound and a PyTorch library call;
 4. slice: the tiny model served on the card against the CPU, then a
    Llama-3-8B Q4_K_M GGUF synthesized from a seed, served by Engine with a
    bf16 and with a q8 KV cache: three prompts (one of 512 tokens), 64
    generated tokens each, one prompt twice for determinism; load time,
    TTFT, pp512 and decode tok/s, peak memory, and each kernel's launches;
 5. the card line, the `kernels` JSON line, and the result line.

Imports nothing of JAX or of the tpullm package. Exits nonzero without CUDA
or without the repository beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

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
# the main path's representative shape per kernel, for the kernels line
REPRESENTATIVE = {"qmm_q4k": "Q4_K gate_up M=1", "qmm_q6k": "Q6_K down M=1",
                  "flash_bf16": "bf16 T=1 S=4096", "flash_q8": "q8 T=1 S=4096"}
REPLACES = {
    "qmm_q4k": "tpullm/ops/pallas/qmm.py:121",
    "qmm_q6k": "tpullm/ops/pallas/qmm.py:121",
    "flash_bf16": "tpullm/ops/pallas/flash.py:69",
    "flash_q8": "tpullm/ops/pallas/flash.py:69",
}
SOURCES = {"qmm_q4k": "tpullm_torch/csrc/qmm.cu", "qmm_q6k": "tpullm_torch/csrc/qmm.cu",
           "flash_bf16": "tpullm_torch/csrc/flash.cu", "flash_q8": "tpullm_torch/csrc/flash.cu"}


def log(*a):
    print(*a, flush=True)


def expect(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nmse(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(((got - ref) ** 2).mean() / (ref * ref).mean().clamp_min(1e-300))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    return smi


def phase_build():
    from tpullm_torch.ops.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] {len(reports)} kernels in {time.perf_counter() - t0:.1f}s "
        f"into {_build.BUILD_DIR}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")


def _random_planes(gtype, n_out: int, n_in: int, gen, dev):
    """Random packed blocks made on the card (as models/synth.random_packed
    makes them on the host), repacked to device planes."""
    import torch

    from tpullm_torch.gguf.constants import TYPE_TRAITS, GGMLType
    from tpullm_torch.ops import qmatmul

    tt = TYPE_TRAITS[gtype]
    nb = n_out * n_in // tt.block_size
    raw = torch.randint(0, 256, (nb, tt.type_size), generator=gen, device=dev,
                        dtype=torch.uint8)
    d = ((torch.rand(nb, generator=gen, device=dev) + 0.5) * 0.02).to(torch.float16)
    db = d.view(torch.uint8).reshape(nb, 2)
    for off in ((0, 2) if gtype == GGMLType.Q4_K else (208,)):
        raw[:, off:off + 2] = db
    return qmatmul.repack(raw.reshape(-1), gtype, n_out, n_in, dev)


def phase_qmm(dev, results: dict):
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    gen = torch.Generator(dev).manual_seed(0)
    for gtype, key in ((GGMLType.Q4_K, "qmm_q4k"), (GGMLType.Q6_K, "qmm_q6k")):
        for name, K, N in QMM_SHAPES:
            planes = _random_planes(gtype, N, K, gen, dev)
            plane_bytes = sum(t.numel() * t.element_size() for t in planes.values())
            w_lib = qmatmul.dequant_planes(planes, gtype, N, K, dtype=torch.bfloat16)
            for M in (1, 512):
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                got = qmm.qmm(x, planes, gtype, N, K)
                ref = qmm.qmm_reference(x, planes, gtype, N, K)
                torch.cuda.synchronize()
                err = nmse(got.float(), ref.float())
                mae = float((got.float() - ref.float()).abs().max())
                label = f"{gtype.name} {name} M={M}"
                expect(bool(torch.isfinite(got.float()).all()), f"{label} finite")
                expect(err <= QMM_NMSE_BOUND, f"{label} NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
                ms = time_ms(lambda: qmm.qmm(x, planes, gtype, N, K), 20 if M == 1 else 5)
                plain = time_ms(lambda: qmm.qmm_reference(x, planes, gtype, N, K), 2, 1)
                lib = time_ms(lambda: torch.matmul(x, w_lib), 20 if M == 1 else 5)
                bms, by = bound_ms(M * K * 2 + plane_bytes + M * N * 2, 2.0 * M * K * N)
                row = dict(case=label, nmse=err, max_abs_err=mae, ms=ms, plain_ms=plain,
                           bound_ms=bms, bound_by=by, library_ms=lib,
                           gbps=(plane_bytes + M * K * 2 + M * N * 2) / ms / 1e6)
                results.setdefault(key, []).append(row)
                log(f"[qmm] {label}: nmse {err:.2e} max|d| {mae:.3g} kernel {ms:.4f} ms "
                    f"({row['gbps']:.0f} GB/s) bound {bms:.4f} ms ({by}) plain {plain:.3f} ms "
                    f"cublas-on-dequantized {lib:.4f} ms")
            del w_lib, planes
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

        def kernel():
            return flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, scale, softcap,
                                            window, sk, sl)

        def plain():
            return flash.flash_reference(q, k_q, v_q, off, scale, softcap, window, sk, sl,
                                         k_scale=k_s, v_scale=v_s)
        k_lib = (k_q.float() * k_s[..., None]).to(torch.bfloat16)
        v_lib = (v_q.float() * v_s[..., None]).to(torch.bfloat16)
    else:
        def kernel():
            return flash.flash_attention(q, k, v, off, scale, softcap, window, sk, sl)

        def plain():
            return flash.flash_reference(q, k, v, off, scale, softcap, window, sk, sl)
        k_lib, v_lib = k, v
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    row = dict(nmse=nmse(got.float(), ref.float()),
               max_abs_err=float((got.float() - ref.float()).abs().max()),
               finite=bool(torch.isfinite(got.float()).all()))
    if not timed:
        return row
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
    row.update(ms=time_ms(kernel, 10), plain_ms=time_ms(plain, 2, 1), bound_ms=bms,
               bound_by=by, library_ms=time_ms(library, 10))
    return row


def phase_flash(dev, results: dict):
    import torch

    gen = torch.Generator(dev).manual_seed(1)
    main = dict(B=2, H=32, Hkv=8, D=128, S=4096)
    for q8, key in ((False, "flash_bf16"), (True, "flash_q8")):
        bound = FLASH_Q8_NMSE_BOUND if q8 else FLASH_NMSE_BOUND
        cases = [(f"{'q8' if q8 else 'bf16'} T=1 S=4096", dict(T=1, offsets=(37, 3000), **main)),
                 (f"{'q8' if q8 else 'bf16'} T=512 S=4096", dict(T=512, offsets=(0, 2500), **main))]
        small = dict(B=2, H=8, Hkv=2, S=300)
        cases += [
            ("softcap", dict(T=40, offsets=(0, 250), D=128, softcap=30.0, **small)),
            ("window", dict(T=40, offsets=(5, 200), D=64, window=48, **small)),
            ("sinks", dict(T=1, offsets=(0, 280), D=128, sinks=True, **small)),
            ("alibi", dict(T=33, offsets=(10, 240), D=64, alibi=True, **small)),
            ("all", dict(T=20, offsets=(3, 270), D=128, softcap=25.0, window=32, sinks=True,
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
                extra = (f" kernel {row['ms']:.4f} ms bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_by']}) plain {row['plain_ms']:.3f} ms "
                         f"sdpa {row['library_ms']:.4f} ms")
            log(f"[flash] {row['case']}: nmse {row['nmse']:.2e} max|d| "
                f"{row['max_abs_err']:.3g}{extra}")
    torch.cuda.empty_cache()


def reset_launches():
    from tpullm_torch.ops.kernels import flash, qmm

    for d in (qmm.LAUNCHES, flash.LAUNCHES):
        for k in d:
            d[k] = 0


def read_launches() -> dict:
    from tpullm_torch.ops.kernels import flash, qmm

    return {"qmm_q4k": qmm.LAUNCHES["Q4_K"], "qmm_q6k": qmm.LAUNCHES["Q6_K"],
            "flash_bf16": flash.LAUNCHES["bf16"], "flash_q8": flash.LAUNCHES["q8"]}


def expected_launches(params, n_forwards: int) -> tuple[int, int]:
    """(qmm launches, flash launches) for n_forwards forward passes."""
    from tpullm_torch.models.weights import FusedLinear

    per = 1 if params["output"] is not None else 0
    for layer in params["layers"]:
        per += 1 + 1 + 1  # attention out, ffn down, and gate+up fused or not
        per += 1 if isinstance(layer.get("wqkv"), FusedLinear) else 3
        if layer.get("wgu") is None:
            per += 1
    return per * n_forwards, len(params["layers"]) * n_forwards


def phase_tiny(dev, tmp: Path):
    """The tiny model on the card against the same model on the CPU."""
    import torch

    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp / "tiny.gguf", shape="tiny", seed=0)
    for kv in (torch.bfloat16, "q8_0"):
        gpu = Engine(path, max_seq=256, kv_dtype=kv)
        cpu = Engine(path, device="cpu", max_seq=256, kv_dtype=kv)
        ids = gpu.tokenizer.tokenize("the quick brown fox jumps over the lazy dog")
        errs = [nmse(torch.from_numpy(gpu.prefill(ids)), torch.from_numpy(cpu.prefill(ids)))]
        for tok in (300, 17, 42, 260, 5):
            errs.append(nmse(torch.from_numpy(gpu.decode_step(tok)),
                             torch.from_numpy(cpu.decode_step(tok))))
        gpu.reset()
        cpu.reset()
        a = gpu.generate_tokens_device(ids, 16)
        b = cpu.generate_tokens_device(ids, 16)
        log(f"[tiny] kv={'bf16' if kv is torch.bfloat16 else kv}: logits NMSE card vs cpu max {max(errs):.2e}; greedy "
            f"{'equal' if a == b else 'DIFFERENT'}")
        expect(max(errs) <= 1e-3, f"tiny kv={kv} logits NMSE {max(errs):.3e} <= 1e-3")
        expect(a == b, f"tiny kv={kv} greedy ids card {a} vs cpu {b}")


def profile_decode(eng, ids, steps: int = 16) -> dict:
    """Device time of `steps` decode steps by kernel family, from
    torch.profiler (the steps read their logits back, as decode_step does)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.reset()
    tok = int(np.argmax(eng.prefill(ids)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok = int(np.argmax(eng.decode_step(tok)))
        torch.cuda.synchronize()
    fam = {"qmm": 0.0, "flash": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if us <= 0.0:
            continue
        kind = "qmm" if "qmm" in e.key else "flash" if "flash_kernel" in e.key else "other"
        fam[kind] += us
        top.append((us, e.key, e.count))
    top.sort(reverse=True)
    return {"steps": steps,
            "device_ms_per_token": {k: v / 1e3 / steps for k, v in fam.items()},
            "top": [(name[:60], round(us / 1e3 / steps, 4), n) for us, name, n in top[:8]]}


def phase_slice(dev, tmp: Path, launches: dict) -> list[dict]:
    import torch

    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    t0 = time.perf_counter()
    path = make_synthetic_llama_gguf(tmp / "llama-3-8b-q4_k_m.gguf", shape="llama-3-8b", seed=0)
    log(f"[slice] synthesized {Path(path).stat().st_size / 2**30:.2f} GiB Llama-3-8B Q4_K_M "
        f"GGUF in {time.perf_counter() - t0:.1f}s")
    n_gen = 64
    runs = []
    for kv in (torch.bfloat16, "q8_0"):
        kv_name = "bf16" if kv is torch.bfloat16 else "q8_0"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # just before the main path
        eng = Engine(path, max_seq=4096, kv_dtype=kv)
        tok = eng.tokenizer
        words = "the quick brown fox jumps over the lazy dog hello world".split()
        long_ids = [1] + [tok.vocab.token_to_id["▁" + words[i % len(words)]]
                          for i in range(511)]
        prompts = [tok.tokenize("hello world"),
                   tok.tokenize(" ".join(words * 6)),
                   long_ids]
        expect(len(long_ids) == 512, "the long prompt has 512 tokens")
        # one short generation first: lazy set-up (allocator, first launches)
        # is paid once per process, not per request
        eng.generate_tokens_device(prompts[0], 8, temp=0.0, stop_on_eog=False)
        forwards = 1 + eng.perf.n_decode
        per_prompt = []
        for i, ids in enumerate(prompts + [prompts[1]]):
            eng.reset()
            p0 = (eng.perf.t_prefill_s, eng.perf.t_decode_s, eng.perf.n_decode)
            out = eng.generate_tokens_device(ids, n_gen, temp=0.0, stop_on_eog=False)
            ttft = eng.perf.t_prefill_s - p0[0]
            dec_s, dec_n = eng.perf.t_decode_s - p0[1], eng.perf.n_decode - p0[2]
            forwards += 1 + dec_n
            expect(len(out) == n_gen, f"prompt {i}: {len(out)} tokens generated")
            expect(all(0 <= t < eng.hp.n_vocab for t in out), "token ids in range")
            per_prompt.append(dict(n_prompt=len(ids), ttft_s=ttft, decode_tok_s=dec_n / dec_s,
                                   out=out))
            log(f"[slice] kv={kv_name} prompt {i} ({len(ids)} tok): TTFT {ttft * 1e3:.1f} ms "
                f"({len(ids) / ttft:.1f} tok/s prefill), decode {dec_n / dec_s:.2f} tok/s "
                f"over {dec_n} steps, first ids {out[:6]}")
        expect(per_prompt[3]["out"] == per_prompt[1]["out"], "greedy output is deterministic")
        prof = profile_decode(eng, prompts[0])
        forwards += 1 + prof["steps"]
        busy = sum(prof["device_ms_per_token"].values())
        wall = 1e3 / float(np.median([p["decode_tok_s"] for p in per_prompt]))
        log(f"[slice] kv={kv_name} profile: device ms per decode token "
            f"{ {k: round(v, 4) for k, v in prof['device_ms_per_token'].items()} } = "
            f"{busy:.3f} ms busy of {wall:.3f} ms per token unprofiled (median rate) "
            f"(idle share {1 - busy / wall:.3f}); top {prof['top']}"
            if busy > 0 else f"[slice] kv={kv_name} profile: no device time recorded "
            "(device busy share not measured)")
        eng.reset()
        logits = eng.prefill(prompts[0])
        forwards += 1
        expect(logits.shape == (eng.hp.n_vocab,) and bool(np.isfinite(logits).all()),
               "final logits finite, [n_vocab]")
        torch.cuda.synchronize()
        got = read_launches()  # just after the main path
        peak = torch.cuda.max_memory_allocated() / 2**30
        want_qmm, want_flash = expected_launches(eng.params, forwards)
        fkey = "flash_bf16" if kv_name == "bf16" else "flash_q8"
        log(f"[slice] kv={kv_name}: load {eng.perf.t_load_s:.1f}s, peak memory {peak:.2f} GiB, "
            f"launches {got} over {forwards} forwards (qmm expected {want_qmm}, flash "
            f"expected {want_flash})")
        expect(got["qmm_q4k"] > 0 and got["qmm_q6k"] > 0, "both qmm formats launched")
        expect(got["qmm_q4k"] + got["qmm_q6k"] == want_qmm, "qmm launches = forwards × linears")
        expect(got[fkey] == want_flash, "flash launches = forwards × n_layer")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        runs.append(dict(kv=kv_name, load_s=eng.perf.t_load_s, peak_gib=peak,
                         ttft_ms=[p["ttft_s"] * 1e3 for p in per_prompt],
                         pp512_tok_s=512 / per_prompt[2]["ttft_s"],
                         decode_tok_s=[p["decode_tok_s"] for p in per_prompt],
                         launches=got, forwards=forwards,
                         device_ms_per_token=prof["device_ms_per_token"]))
        del eng
    return runs


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

    smi = phase_card()
    phase_build()
    results: dict = {}
    phase_qmm(dev, results)
    phase_flash(dev, results)
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="tpullm_torch_smoke_") as tmp:
        phase_tiny(dev, Path(tmp))
        runs = phase_slice(dev, Path(tmp), launches)
    log("[slice] summary " + json.dumps({"slice": runs}))

    kernels = []
    for key in ("qmm_q4k", "qmm_q6k", "flash_bf16", "flash_q8"):
        rows = results[key]
        rep = next(r for r in rows if r["case"] == REPRESENTATIVE[key])
        kernels.append(dict(
            name=key, route="cuda", source=SOURCES[key], replaces=REPLACES[key],
            launches=launches[key], max_abs_err=max(r["max_abs_err"] for r in rows),
            max_nmse=max(r["nmse"] for r in rows), case=rep["case"], ms=rep["ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"]))
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
