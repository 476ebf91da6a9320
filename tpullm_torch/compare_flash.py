"""Parent against change for flash's decode kernel on one card: the
library `flash` (csrc/flash.cu) of both checkouts built side by side with
nvcc -Xptxas -v (each decode kernel's registers and spill bytes printed),
then the decode kernel timed at the shapes of the decode regime before its
row groups (R ≤ 16: the 8B's T = 1 at B = 2 and B = 1, its T = 4, Gemma's
head dim 256, head dim 64) in turns parent, change, change, parent, each a
CUDA-graph replay (chip_smoke.time_ms), the two outputs compared bit for
bit. JSON to chiprun_out/compare_flash.json.

    python3 tpullm_torch/compare_flash.py --parent build/parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, B, T, H, Hkv, D, offsets) at S = 4096
CASES = (("8B T=1 B=2 kv=38/3001", 2, 1, 32, 8, 128, (37, 3000)),
         ("8B T=1 B=1 kv=20", 1, 1, 32, 8, 128, (19,)),
         ("8B T=4 B=1 off=2500 (R=16)", 1, 4, 32, 8, 128, (2500,)),
         ("gemma D=256 T=1 B=2", 2, 1, 8, 4, 256, (37, 3000)),
         ("D=64 H=8/2 T=1 B=2", 2, 1, 8, 2, 64, (37, 3000)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True, help="the parent's checkout")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from tpullm_torch.ops.kernels import _build, flash

    out_dir = ROOT / "build" / "compare_flash"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"parent": args.parent.resolve() / "tpullm_torch" / "csrc",
             "change": ROOT / "tpullm_torch" / "csrc"}

    def build(name):
        so = out_dir / f"flash_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(trees[name]), "-o", str(so),
               str(trees[name] / "flash.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(proc.stdout + proc.stderr)
        return name, so, proc.stdout + proc.stderr

    with ThreadPoolExecutor(2) as ex:
        built = list(ex.map(build, trees))
    libs = {}
    for name, so, report in built:
        kernels = [e for e in cs.ptxas_entries(report) if "flash_decode_kernel" in e[0]]
        print(f"[cmp] {name} decode kernels (name, regs, spill stores, spill loads): {kernels}",
              flush=True)
        fn = getattr(ctypes.CDLL(str(so)), "tpullm_flash_bf16")
        fn.argtypes, fn.restype = flash._DENSE_ARGS, ctypes.c_int
        libs[name] = fn
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(dev).manual_seed(5)
    rows = []
    for label, B, T, H, Hkv, D, offsets in CASES:
        S = 4096
        q = torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        R = T * H // Hkv
        n_split = flash.max_splits(B, Hkv, S, n_sm)
        calls = {}
        for name, fn in libs.items():
            out = torch.empty(B, T, H, D, dtype=torch.bfloat16, device=dev)
            partial = torch.empty(B * Hkv * n_split * R * (D + 2), dtype=torch.float32,
                                  device=dev)
            counters = torch.zeros(B * Hkv * 16, dtype=torch.int32, device=dev)

            def call(fn=fn, out=out, partial=partial, counters=counters):
                stream = torch.cuda.current_stream().cuda_stream
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(), None,
                                None, out.data_ptr(), partial.data_ptr(), counters.data_ptr(), B,
                                T, H, Hkv, S, D, D, float(D ** -0.5), 0.0, 0, n_split, stream),
                             f"flash {name} {label}")
                return out
            calls[name] = (call, call().clone())
        torch.cuda.synchronize()
        times = {"parent": [], "change": []}
        for name in ("parent", "change", "change", "parent"):
            times[name].append(cs.time_ms(calls[name][0], 50))
        row = dict(case=label, R=R,
                   bit_equal=torch.equal(calls["parent"][1], calls["change"][1]),
                   parent_ms=times["parent"], change_ms=times["change"])
        print(f"[cmp] {json.dumps(row)}", flush=True)
        rows.append(row)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "compare_flash.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
