"""tpullm-torch-bench: throughput benchmark matrix (≡ reference
tools/llama-bench), the JAX package's tools/bench.py on the port's Engine.

Cartesian sweep of prompt sizes × generation lengths × prefix depths ×
KV-cache types × weight modes with repetitions; reports t/s ± stddev as
markdown, csv, json, jsonl, or sql (llama-bench.cpp cmd_params
:313-356 / output_formats :403 analog — the sql form feeds
tpullm-torch-compare-bench the way compare-llama-bench.py diffs sqlite
runs). The rows have the JAX tool's keys and sql schema.

pp is one prefill of the prompt (its logits read back); tg is a loop of
`Engine.decode_step`, the logits-only step (on the card a CUDA-graph replay
a token), each token's logits read back. The MI50 fork's own recipe runs
verbatim:
    python -m tpullm_torch.tools.bench -m model.gguf -fa 1 -ctk q8_0 \\
        -p 512,2048,8192 -n 1,128,2048 -d 512
(-fa is accepted for recipe compatibility; attention is always the flash
kernel, so 0 only annotates the row.)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def _parse_int_list(s: str) -> list[int]:
    return [int(x) for x in str(s).split(",") if x != ""]


def _parse_str_list(s: str) -> list[str]:
    return [x.strip() for x in str(s).split(",") if x.strip()]


def bench_case(eng, n_prompt: int, n_gen: int, depth: int, reps: int) -> dict:
    import numpy as np

    pp_rates, tg_rates = [], []
    vocab_top = min(1000, eng.hp.n_vocab - 1)
    rng = np.random.default_rng(0)
    for _ in range(reps):
        eng.reset()
        if depth > 0:  # un-timed deep prefix (≡ llama-bench -d)
            eng.prefill(rng.integers(3, vocab_top, size=depth).tolist())
        toks = rng.integers(3, vocab_top, size=max(n_prompt, 1)).tolist()
        t0 = time.perf_counter()
        if n_prompt > 0:
            eng.prefill(toks)
            pp_rates.append(n_prompt / (time.perf_counter() - t0))
        else:
            eng.prefill(toks[:1])
        if n_gen > 0:
            # decode loop through the single-step path for exact counting
            t0 = time.perf_counter()
            tok = toks[0]
            for _ in range(n_gen):
                logits = eng.decode_step(tok)
                tok = int(np.argmax(logits[:32]))  # cheap argmax slice
            tg_rates.append(n_gen / (time.perf_counter() - t0))
    case = {"n_prompt": n_prompt, "n_gen": n_gen, "n_depth": depth}
    if pp_rates:
        case["pp_ts"] = round(statistics.mean(pp_rates), 2)
        case["pp_stddev"] = round(statistics.stdev(pp_rates), 2) if len(pp_rates) > 1 else 0.0
    if tg_rates:
        case["tg_ts"] = round(statistics.mean(tg_rates), 2)
        case["tg_stddev"] = round(statistics.stdev(tg_rates), 2) if len(tg_rates) > 1 else 0.0
    return case


def run_matrix(model, n_prompt, n_gen, depths, reps, mode, ctx,
               kv_types, fa: int = 1, device: str = "cuda") -> list[dict]:
    from ..runtime.engine import Engine

    rows = []
    for ctk in kv_types:
        eng = None
        for d in depths:
            for p in n_prompt:
                for g in n_gen:
                    if p == 0 and g == 0:
                        continue
                    need = d + p + g + 8
                    case_ctx = max(ctx, -(-need // 256) * 256)
                    if eng is None or eng.max_seq < case_ctx:
                        eng = None  # the old engine's memory goes before the new one loads
                        eng = Engine(model, device=device, mode=mode, max_seq=case_ctx,
                                     kv_dtype=ctk)
                    row = {"model": str(model), "mode": mode,
                           "type_kv": str(ctk), "fa": fa,
                           **bench_case(eng, p, g, d, reps)}
                    rows.append(row)
                    print(_fmt_md_row(row), file=sys.stderr)
    return rows


_MD_HEADER = "| model | mode | kv | d | pp | tg | pp t/s | tg t/s |"
_MD_NCOL = 8

_SQL_COLS = ("model", "mode", "type_kv", "fa", "n_prompt", "n_gen",
             "n_depth", "pp_ts", "pp_stddev", "tg_ts", "tg_stddev")


def _fmt_md_row(r: dict) -> str:
    pp = f"{r.get('pp_ts', '-')} ± {r.get('pp_stddev', 0)}" if "pp_ts" in r else "-"
    tg = f"{r.get('tg_ts', '-')} ± {r.get('tg_stddev', 0)}" if "tg_ts" in r else "-"
    return (f"| {os.path.basename(r['model'])} | {r['mode']} | "
            f"{r.get('type_kv', 'bf16')} | {r.get('n_depth', 0)} | "
            f"{r['n_prompt']} | {r['n_gen']} | {pp} | {tg} |")


def _sql_quote(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, (int, float)):
        return str(v)
    return "'" + str(v).replace("'", "''") + "'"


def emit_sql(rows: list[dict], out=None) -> None:
    """SQLite-ready dump (≡ llama-bench -o sql): pipe into `sqlite3 db` and
    diff runs with tpullm-torch-compare-bench or plain SQL."""
    out = out if out is not None else sys.stdout
    cols = ", ".join(f"{c} {'TEXT' if c in ('model', 'mode', 'type_kv') else 'REAL'}"
                     for c in _SQL_COLS)
    print(f"CREATE TABLE IF NOT EXISTS bench ({cols});", file=out)
    for r in rows:
        vals = ", ".join(_sql_quote(r.get(c)) for c in _SQL_COLS)
        print(f"INSERT INTO bench ({', '.join(_SQL_COLS)}) VALUES ({vals});",
              file=out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-bench")
    ap.add_argument("-m", "--model", action="append", required=True)
    ap.add_argument("-p", "--n-prompt", default="512", type=_parse_int_list)
    ap.add_argument("-n", "--n-gen", default="128", type=_parse_int_list)
    ap.add_argument("-d", "--n-depth", default="0", type=_parse_int_list,
                    help="prefix depths: decode/prefill measured after an "
                         "un-timed d-token prompt (≡ llama-bench -d)")
    ap.add_argument("-ctk", "--cache-type-k", default="bf16",
                    type=_parse_str_list,
                    help="KV cache types to sweep: bf16, f16, f32, q8_0")
    ap.add_argument("-ctv", "--cache-type-v", default=None,
                    type=_parse_str_list,
                    help="accepted for recipe compatibility; the cache "
                         "stores K and V in ONE type, so this must equal "
                         "-ctk when given")
    ap.add_argument("-fa", "--flash-attn", type=int, default=1,
                    help="accepted for recipe compatibility (attention is "
                         "always the flash kernel); annotates rows")
    ap.add_argument("-r", "--repetitions", type=int, default=3)
    ap.add_argument("-c", "--ctx-size", type=int, default=4096)
    ap.add_argument("--mode", default="auto", choices=["auto", "quant", "dense"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their plain versions)")
    ap.add_argument("-o", "--output", default="md",
                    choices=["md", "csv", "json", "jsonl", "sql"])
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the sweep (Chrome trace JSON) "
                         "into DIR")
    args = ap.parse_args(argv)

    if args.cache_type_v is not None and args.cache_type_v != args.cache_type_k:
        ap.error("-ctv must equal -ctk (unified KV storage type)")
    kv_types = [("q8_0" if t in ("q8_0", "q8") else t)
                for t in args.cache_type_k]

    def sweep():
        rows = []
        for model in args.model:
            rows += run_matrix(model, args.n_prompt, args.n_gen,
                               args.n_depth, args.repetitions, args.mode,
                               args.ctx_size, kv_types, args.flash_attn, args.device)
        return rows

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if args.device != "cpu":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            rows = sweep()
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "bench_trace.json")
        prof.export_chrome_trace(trace)
        print(f"profile trace written to {trace}", file=sys.stderr)
    else:
        rows = sweep()

    if args.output == "json":
        print(json.dumps(rows, indent=2))
    elif args.output == "jsonl":
        for r in rows:
            print(json.dumps(r))
    elif args.output == "sql":
        emit_sql(rows)
    elif args.output == "csv":
        keys = list(_SQL_COLS)
        print(",".join(keys))
        for r in rows:
            print(",".join(str(r.get(k, "")) for k in keys))
    else:
        print(_MD_HEADER)
        print("|" + "---|" * _MD_NCOL)
        for r in rows:
            print(_fmt_md_row(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
