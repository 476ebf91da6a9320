"""tpullm-torch-batched-bench: the parallel-decode throughput grid (the JAX
package's tools/batched_bench.py, ≡ llama-batched-bench), on the port's
BatchEngine: for each (PP, TG, B), B slots prefill PP tokens each in joint
rounds, then decode TG steps with all B slots in one batched step (the
decode graph of width B, captured before the first case, so no timed
window holds a capture); per-phase and total t/s.

    tpullm-torch-batched-bench -m model.gguf -npp 128 -ntg 64 -npl 1,2,4,8

Runs on the card unless asked for the CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_int_list(s: str) -> list[int]:
    return [int(x) for x in str(s).split(",") if x != ""]


def run_case(eng, pp: int, tg: int, b: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(0)
    vocab_top = min(1000, eng.hp.n_vocab - 1)
    for slot in range(b):
        eng.free_slot(slot)

    # both phases end in a read-back of their results (logits, ids): the
    # host clock holds the card's time
    t0 = time.perf_counter()
    eng.prefill_slots({
        slot: rng.integers(3, vocab_top, size=pp).tolist()
        for slot in range(b)
    })  # joint batched prompt phase (the scheduler's admission path)
    t_pp = time.perf_counter() - t0

    t0 = time.perf_counter()
    cur = {slot: 5 for slot in range(b)}
    for _ in range(tg):
        cur = eng.decode_batch_greedy(cur)  # ids-only read-back
    t_tg = time.perf_counter() - t0

    n_pp, n_tg = pp * b, tg * b
    return {
        "pp": pp, "tg": tg, "b": b,
        "t_pp_s": round(t_pp, 3), "pp_ts": round(n_pp / t_pp, 2),
        "t_tg_s": round(t_tg, 3), "tg_ts": round(n_tg / t_tg, 2),
        "t_total_s": round(t_pp + t_tg, 3),
        "total_ts": round((n_pp + n_tg) / (t_pp + t_tg), 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-batched-bench")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-npp", default="128,256", type=_parse_int_list)
    ap.add_argument("-ntg", default="16,32", type=_parse_int_list)
    ap.add_argument("-npl", default="1,2,4", type=_parse_int_list,
                    help="parallel sequence counts")
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--mode", default="auto", choices=["auto", "quant", "dense"])
    ap.add_argument("-o", "--output", default="md", choices=["md", "json"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from ..runtime.batch_engine import BatchEngine

    n_slots = max(args.npl)
    eng = BatchEngine(args.model, device=args.device, n_slots=n_slots,
                      max_seq=args.ctx_size, mode=args.mode)
    eng.precompile()  # every width's decode graph, captured before any timed step
    rows = []
    for pp in args.npp:
        for tg in args.ntg:
            for b in args.npl:
                if (pp + tg) >= args.ctx_size:
                    continue
                rows.append(run_case(eng, pp, tg, b))
                print(rows[-1], file=sys.stderr)

    if args.output == "json":
        print(json.dumps(rows, indent=2))
    else:
        print("| PP | TG | B | PP t/s | TG t/s | total t/s |")
        print("|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['pp']} | {r['tg']} | {r['b']} | {r['pp_ts']} "
                  f"| {r['tg_ts']} | {r['total_ts']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
