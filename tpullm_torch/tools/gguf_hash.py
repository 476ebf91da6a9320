"""tpullm-torch-gguf-hash: per-tensor and whole-model content hashes (the
JAX package's tools/gguf_hash.py: the same lines and digests; reference
gguf-py/gguf/scripts/gguf_hash.py).

One line per tensor and algorithm, then the whole model's hash per
algorithm and its UUIDv5 (from the sha256 over every tensor's bytes in
order), so two GGUFs compare tensor by tensor whatever their metadata;
blake2b-64 stands where the reference offers xxh64. A split model hashes
as the whole file through its first shard.

    python -m tpullm_torch.tools.gguf_hash model.gguf [--sha256 --sha1 --blake2b64 --all]
        [--no-layer]
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import uuid

from ..gguf.reader import GGUFReader

# the namespace of the model UUID (the JAX tool's)
_UUID_NS = uuid.UUID("ef001206-dadc-5f6d-a15f-3359e577d4e5")


def hash_gguf(path: str, algos: list[str], no_layer: bool = False,
              out=None) -> dict[str, str]:
    """Prints the hash lines of `path` to `out` (stdout); returns the whole
    model's digest per algorithm and its "uuid"."""
    out = out or sys.stdout
    r = GGUFReader(path)
    # the UUID always derives from sha256, whatever algorithms are asked for
    uuid_algos = list(dict.fromkeys(algos + ["sha256"]))
    whole = {a: _new(a) for a in uuid_algos}
    totals: dict[str, str] = {}
    for name, info in r.tensors.items():
        data = memoryview(info.data)
        for a in uuid_algos:
            whole[a].update(data)
        if not no_layer:
            for a in algos:
                h = _new(a)
                h.update(data)
                print(f"{a}\t{h.hexdigest()}\t{path}:{name}", file=out)
    for a in uuid_algos:
        totals[a] = whole[a].hexdigest()
        if a in algos:
            print(f"{a}\t{totals[a]}\t{path}", file=out)
    model_uuid = uuid.uuid5(_UUID_NS, totals["sha256"])
    print(f"uuid\t{model_uuid}\t{path}", file=out)
    totals["uuid"] = str(model_uuid)
    return totals


def _new(algo: str):
    if algo == "blake2b64":
        return hashlib.blake2b(digest_size=8)
    return hashlib.new(algo)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-gguf-hash")
    ap.add_argument("model")
    ap.add_argument("--sha256", action="store_true")
    ap.add_argument("--sha1", action="store_true")
    ap.add_argument("--blake2b64", action="store_true",
                    help="fast 64-bit hash (role of the reference's xxh64)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-layer", action="store_true",
                    help="overall hashes only, skip per-tensor lines")
    args = ap.parse_args(argv)
    algos = []
    if args.blake2b64 or args.all or not (args.sha256 or args.sha1):
        algos.append("blake2b64")
    if args.sha1 or args.all:
        algos.append("sha1")
    if args.sha256 or args.all:
        algos.append("sha256")
    hash_gguf(args.model, algos, no_layer=args.no_layer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
