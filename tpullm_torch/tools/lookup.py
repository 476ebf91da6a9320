"""tpullm-torch-lookup: n-gram cache tooling and lookup decoding (the JAX
package's tpullm-lookup on the port's Engine; ≡ reference
tools/lookup/{lookup-create,lookup-merge,lookup-stats,lookup}).

Subcommands:
  create  -m model.gguf -f corpus.txt -o cache.npz   build a static cache
  merge   a.npz b.npz ... -o out.npz                 merge caches
  stats   cache.npz                                   print cache stats
  run     -m model.gguf -p prompt [--static cache]    generate with lookup

`create` reads only the model's tokenizer; `run` generates on the card
(`--device cuda`, the default) unless asked for the CPU (`--device cpu`).
The caches are the npz files of runtime/ngram_cache.py, which the JAX
package's tool reads and writes too.
"""

from __future__ import annotations

import argparse
import sys


def cmd_create(args):
    from .. import tokenizer as tokenizer_mod
    from ..gguf.reader import GGUFReader
    from ..runtime.ngram_cache import NgramCache

    tok = tokenizer_mod.from_gguf(GGUFReader(args.model))
    with open(args.file, encoding="utf-8", errors="replace") as f:
        text = f.read()
    toks = tok.tokenize(text, add_special=False)
    cache = NgramCache()
    cache.update(list(toks))
    cache.save(args.output)
    print(f"{cache.n_grams()} n-grams / {cache.n_observations()} observations "
          f"from {len(toks)} tokens -> {args.output}")
    return 0


def cmd_merge(args):
    from ..runtime.ngram_cache import NgramCache

    out = NgramCache.load(args.caches[0])
    for p in args.caches[1:]:
        out.merge(NgramCache.load(p))
    out.save(args.output)
    print(f"merged {len(args.caches)} caches -> {args.output} "
          f"({out.n_grams()} n-grams)")
    return 0


def cmd_stats(args):
    from ..runtime.ngram_cache import NgramCache

    cache = NgramCache.load(args.cache)
    by_size: dict[int, int] = {}
    for key in cache.grams:
        by_size[len(key)] = by_size.get(len(key), 0) + 1
    print(f"n-grams: {cache.n_grams()}  observations: {cache.n_observations()}")
    for size in sorted(by_size):
        print(f"  {size}-grams: {by_size[size]}")
    return 0


def cmd_run(args):
    from ..runtime.engine import Engine
    from ..runtime.ngram_cache import NgramCache, NgramCacheSpeculator
    from ..runtime.sampling import Sampler, SamplerParams
    from ..runtime.speculative import generate_speculative

    eng = Engine(args.model, device=args.device, mode=args.mode, max_seq=args.ctx_size)
    spec = NgramCacheSpeculator(
        n_draft=args.draft,
        dynamic=NgramCache.load(args.dynamic) if args.dynamic else None,
        static=NgramCache.load(args.static) if args.static else None,
    )
    sampler = Sampler(SamplerParams(temp=args.temp))
    ids = eng.tokenizer.tokenize(args.prompt, add_special=True)
    out, stats = generate_speculative(
        eng, spec, list(ids), max_new_tokens=args.n_predict, sampler=sampler
    )
    print(eng.tokenizer.detokenize(out))
    print(f"\nn_drafted={stats.n_drafted} n_accepted={stats.n_accepted} "
          f"accept_rate={stats.accept_rate:.3f}", file=sys.stderr)
    if args.dynamic and args.update_dynamic:
        spec.dynamic.save(args.dynamic)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-lookup")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create")
    c.add_argument("-m", "--model", required=True)
    c.add_argument("-f", "--file", required=True)
    c.add_argument("-o", "--output", required=True)
    c.set_defaults(fn=cmd_create)

    m = sub.add_parser("merge")
    m.add_argument("caches", nargs="+")
    m.add_argument("-o", "--output", required=True)
    m.set_defaults(fn=cmd_merge)

    s = sub.add_parser("stats")
    s.add_argument("cache")
    s.set_defaults(fn=cmd_stats)

    r = sub.add_parser("run")
    r.add_argument("-m", "--model", required=True)
    r.add_argument("-p", "--prompt", required=True)
    r.add_argument("-n", "--n-predict", type=int, default=128)
    r.add_argument("-c", "--ctx-size", type=int, default=2048)
    r.add_argument("--draft", type=int, default=5)
    r.add_argument("--temp", type=float, default=0.0)
    r.add_argument("--static", help="static cache npz (lookup-create output)")
    r.add_argument("--dynamic", help="dynamic cache npz, updated when "
                   "--update-dynamic is set")
    r.add_argument("--update-dynamic", action="store_true")
    r.add_argument("--mode", choices=["auto", "quant", "dense"], default="auto")
    r.add_argument("--device", default="cuda",
                   help="cuda (the hand-written kernels) or cpu (their plain versions)")
    r.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
