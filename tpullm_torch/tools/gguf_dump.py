"""tpullm-torch-gguf-dump: a GGUF file's metadata and tensor index (the
JAX package's tools/gguf_dump.py, its flags and output; reference
gguf-py/gguf/scripts/gguf_dump.py). A split model's first shard lists the
tensors of every shard.

    python -m tpullm_torch.tools.gguf_dump model.gguf [--json] [--no-tensors]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..gguf.constants import TYPE_TRAITS
from ..gguf.reader import GGUFReader


def bits_per_weight(gtype) -> float:
    tt = TYPE_TRAITS[gtype]
    return tt.type_size * 8 / tt.block_size


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dump GGUF metadata and tensors")
    ap.add_argument("path")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--no-tensors", action="store_true")
    args = ap.parse_args(argv)

    r = GGUFReader(args.path)
    if args.json:
        meta = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in r.metadata.items()
                if not (isinstance(v, (list, np.ndarray)) and len(v) > 64)}
        out = {
            "version": r.version,
            "alignment": r.alignment,
            "metadata": meta,
            "tensors": [{"name": t.name, "type": t.ggml_type.name, "shape": list(t.shape),
                         "bytes": t.n_bytes}
                        for t in r.tensors.values()] if not args.no_tensors else [],
        }
        json.dump(out, sys.stdout, indent=2, default=str)
        print()
        return 0

    print(f"GGUF v{r.version}, alignment {r.alignment}, "
          f"{len(r.metadata)} KV pairs, {len(r.tensors)} tensors")
    for k, v in r.metadata.items():
        if isinstance(v, (list, np.ndarray)) and len(v) > 8:
            desc = f"[{len(v)} items] {list(v[:4])!r}..."
        else:
            desc = repr(v)
        print(f"  {k} = {desc}")
    if not args.no_tensors:
        total = 0
        for t in r.tensors.values():
            total += t.n_bytes
            print(f"  {t.name:48s} {t.ggml_type.name:8s} {str(t.shape):20s} "
                  f"{t.n_bytes/1e6:10.2f} MB  {bits_per_weight(t.ggml_type):.2f} bpw")
        print(f"total tensor bytes: {total/1e9:.3f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
