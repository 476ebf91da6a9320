"""tpullm-torch-gguf-split: shard a GGUF model, or merge its shards (the
JAX package's tools/gguf_split.py, its flags and output; reference
tools/gguf-split).

Shards are named <prefix>-%05d-of-%05d.gguf (llama_split_path) and carry
split.no, split.count and split.tensors.count; the first holds the model's
metadata, the others tensors only. The port's GGUFReader opens a split
model through its first shard (gguf/reader.py), so every loader reads it
as the whole file.

    python -m tpullm_torch.tools.gguf_split [--split-max-tensors N] model.gguf out/prefix
    python -m tpullm_torch.tools.gguf_split --merge out/prefix-00001-of-00003.gguf merged.gguf
"""

from __future__ import annotations

import argparse
import sys

from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter

SPLIT_NO = "split.no"
SPLIT_COUNT = "split.count"
SPLIT_TENSORS = "split.tensors.count"


def split_path(prefix: str, i: int, n: int) -> str:
    """Shard i (from 0) of n (llama_split_path)."""
    return f"{prefix}-{i + 1:05d}-of-{n:05d}.gguf"


def split_model(src: str, out_prefix: str, max_tensors: int = 128,
                verbose: bool = True) -> list[str]:
    """Writes `src` as shards of at most `max_tensors` tensors each, in the
    file's tensor order; returns their paths."""
    r = GGUFReader(src)
    names = list(r.tensors)
    groups = [names[i: i + max_tensors] for i in range(0, len(names), max_tensors)]
    n = len(groups)
    paths = []
    for i, group in enumerate(groups):
        path = split_path(out_prefix, i, n)
        w = GGUFWriter(path, architecture=r.architecture)
        if i == 0:  # the first shard carries the model's metadata
            for k, v in r.metadata.items():
                if k.startswith("split.") or k == "general.architecture":
                    continue
                w.add_kv(k, v)
        w.add_kv(SPLIT_NO, i)
        w.add_kv(SPLIT_COUNT, n)
        w.add_kv(SPLIT_TENSORS, len(r.tensors))
        for name in group:
            t = r.tensors[name]
            w.add_packed_tensor(name, t.shape, t.ggml_type, t.data)
        w.write()
        paths.append(path)
        if verbose:
            print(f"wrote {path} ({len(group)} tensors)", file=sys.stderr)
    r.close()
    return paths


def merge_model(first_shard: str, dst: str, verbose: bool = True) -> str:
    """Writes the model of `first_shard` (its siblings absorbed) as one file."""
    r = GGUFReader(first_shard)
    if not r._shards and int(r.metadata.get(SPLIT_COUNT, 0) or 0) > 1:
        raise ValueError("pass the first shard (-00001-of-....gguf)")
    w = GGUFWriter(dst, architecture=r.architecture)
    for k, v in r.metadata.items():
        if k.startswith("split.") or k == "general.architecture":
            continue
        w.add_kv(k, v)
    for name, t in r.tensors.items():
        w.add_packed_tensor(name, t.shape, t.ggml_type, t.data)
    w.write()
    if verbose:
        print(f"merged {len(r.tensors)} tensors -> {dst}", file=sys.stderr)
    r.close()
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-gguf-split")
    ap.add_argument("--split-max-tensors", type=int, default=128)
    ap.add_argument("--merge", action="store_true")
    ap.add_argument("input")
    ap.add_argument("output", help="output prefix (split) or file (merge)")
    args = ap.parse_args(argv)
    if args.merge:
        merge_model(args.input, args.output)
    else:
        paths = split_model(args.input, args.output, args.split_max_tensors)
        print(f"{len(paths)} shards written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
