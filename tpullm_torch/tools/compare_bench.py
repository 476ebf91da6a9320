"""tpullm-torch-compare-bench: diff two tpullm-torch-bench (or tpullm-bench)
JSON outputs
(≡ reference scripts/compare-llama-bench.py, which diffs llama-bench sqlite
runs between commits). Rows are matched on (model basename, mode, n_prompt,
n_gen); pp/tg rates are reported with relative speedup and flagged when the
change exceeds the combined stddev noise band.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _key(r: dict) -> tuple:
    return (os.path.basename(str(r.get("model", ""))), r.get("mode"),
            r.get("n_prompt"), r.get("n_gen"),
            r.get("n_depth", 0), r.get("type_kv", "bf16"))


def compare(old_rows: list[dict], new_rows: list[dict]) -> list[dict]:
    old = {_key(r): r for r in old_rows}
    out = []
    for r in new_rows:
        base = old.get(_key(r))
        if base is None:
            continue
        row: dict = {"model": _key(r)[0], "mode": r.get("mode"),
                     "pp": r.get("n_prompt"), "tg": r.get("n_gen")}
        for metric in ("pp_ts", "tg_ts"):
            a, b = base.get(metric), r.get(metric)
            if not a or not b:
                continue
            noise = (base.get(metric.replace("_ts", "_stddev"), 0.0)
                     + r.get(metric.replace("_ts", "_stddev"), 0.0))
            row[metric] = {
                "old": a, "new": b,
                "speedup": round(b / a, 4),
                # significant iff the delta clears the summed stddevs
                "significant": abs(b - a) > noise,
            }
        out.append(row)
    return out


def _fmt_md(rows: list[dict]) -> str:
    lines = ["| model | mode | pp | tg | pp t/s old→new | tg t/s old→new |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        def cell(m):
            d = r.get(m)
            if not d:
                return "-"
            mark = "" if not d["significant"] else (
                " 🟢" if d["speedup"] > 1 else " 🔴")
            return f"{d['old']} → {d['new']} ({d['speedup']:.2f}×){mark}"

        lines.append(f"| {r['model']} | {r['mode']} | {r['pp']} | {r['tg']} "
                     f"| {cell('pp_ts')} | {cell('tg_ts')} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-compare-bench")
    ap.add_argument("old", help="baseline tpullm-bench -o json output file")
    ap.add_argument("new", help="candidate tpullm-bench -o json output file")
    ap.add_argument("-o", "--output", default="md", choices=["md", "json"])
    args = ap.parse_args(argv)

    with open(args.old) as f:
        old_rows = json.load(f)
    with open(args.new) as f:
        new_rows = json.load(f)
    rows = compare(old_rows, new_rows)
    if not rows:
        print("no matching rows between the two runs", file=sys.stderr)
        return 1
    if args.output == "json":
        print(json.dumps(rows, indent=2))
    else:
        print(_fmt_md(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
