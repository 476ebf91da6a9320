"""tpullm-torch-server: the OpenAI-compatible server on the card (the JAX
package's tpullm-server, ≡ llama-server).

    tpullm-torch-server -m model.gguf --port 8080 -np 4 -c 4096

Runs on the card unless asked for the CPU (`--device cpu`); several `-m
NAME=PATH` start the multi-model router. Speculative decoding in the
scheduler: `--spec-type` (an n-gram strategy) or `--draft-model` (a draft
GGUF with the target's slot layout), up to `--draft-max` drafts a round.
Multimodal projectors, mesh serving (--tp/--dp/--pp/--ep) and multi-host
flags are refused: not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys

NOT_PORTED = "not ported yet (ROADMAP.md 1.3.{item})"
# the JAX server's flags this one refuses, with their ROADMAP.md 1.3 items
REFUSED = (("--mmproj", 7), ("--tp", 9), ("--dp", 9), ("--pp", 9), ("--ep", 9),
           ("--dist-coordinator", 9), ("--dist-nprocs", 9), ("--dist-procid", 9))
SPEC_TYPES = ("draft", "ngram_simple", "ngram_cache", "ngram_mod", "ngram_map_k",
              "ngram_map_k4v")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpullm-torch-server")
    ap.add_argument("-m", "--model", action="append", default=None,
                    help="model path, or NAME=PATH (repeat for multi-model routing)")
    ap.add_argument("--max-loaded", type=int, default=1,
                    help="resident models before LRU eviction (router mode)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("-c", "--ctx-size", type=int, default=4096)
    ap.add_argument("-np", "--parallel", type=int, default=4, help="number of slots")
    ap.add_argument("--mode", choices=["auto", "quant", "dense"], default="auto")
    ap.add_argument("--prefill-chunk", type=int, default=512)
    ap.add_argument("--api-key", action="append", default=None,
                    help="require this bearer token on non-public endpoints "
                         "(repeatable; env TPULLM_API_KEY)")
    ap.add_argument("--api-key-file", default=None,
                    help="file with one accepted API key per line")
    ap.add_argument("--slot-save-path", default=None,
                    help="directory for /slots/:id?action=save|restore files")
    ap.add_argument("--kv-type", default=None, choices=["f16", "bf16", "f32", "q8_0"],
                    help="KV cache storage type (≡ -ctk/-ctv)")
    ap.add_argument("--draft-model", default=None,
                    help="draft model GGUF for in-scheduler speculative decoding (≡ -md)")
    ap.add_argument("--draft-max", type=int, default=8,
                    help="max draft tokens per speculation step (≡ --draft-max)")
    ap.add_argument("--spec-type", default=None, choices=SPEC_TYPES,
                    help="speculation strategy (default: draft if --draft-model given, "
                         "else off)")
    ap.add_argument("--cache-reuse", type=int, default=0,
                    help="min chunk size for mid-prompt cache reuse via position shifting")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    for flag, item in REFUSED:
        ap.add_argument(flag, default=None, help=NOT_PORTED.format(item=item))
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, item in REFUSED:
        if getattr(args, flag.lstrip("-").replace("-", "_")) is not None:
            ap.error(f"{flag} is {NOT_PORTED.format(item=item)}")
    if not args.model:
        ap.error("-m/--model is required")
    api_keys = list(args.api_key or [])
    if os.environ.get("TPULLM_API_KEY"):
        api_keys.append(os.environ["TPULLM_API_KEY"])
    if args.api_key_file:
        with open(args.api_key_file) as f:
            api_keys += [ln.strip() for ln in f if ln.strip()]

    from .api import make_app, serve

    engine_kw = dict(device=args.device, n_slots=args.parallel, max_seq=args.ctx_size,
                     mode=args.mode, prefill_chunk=args.prefill_chunk)
    if args.kv_type:
        engine_kw["kv_dtype"] = args.kv_type

    if len(args.model) > 1 or "=" in args.model[0]:
        from .router import make_router_app

        models = {}
        for spec in args.model:
            name, _, path = spec.partition("=")
            if not path:
                name, path = spec, spec
            models[name] = path
        router = make_router_app(models, max_loaded=args.max_loaded, api_keys=api_keys,
                                 **engine_kw)
        httpd = serve(router.app, args.host, args.port)
        print(f"tpullm-torch-server router on http://{args.host}:{httpd.server_address[1]} "
              f"({len(models)} models)", file=sys.stderr)
        try:
            httpd.serve_forever_thread.join()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.shutdown()
            httpd.server_close()
            router.shutdown()
        return 0

    app, sched = make_app(args.model[0], slot_save_path=args.slot_save_path,
                          spec_type=args.spec_type, draft_model_path=args.draft_model,
                          n_draft=args.draft_max, cache_reuse=args.cache_reuse,
                          api_keys=api_keys, **engine_kw)
    sched.precompile(background=True)
    httpd = serve(app, args.host, args.port)
    print(f"tpullm-torch-server listening on http://{args.host}:{httpd.server_address[1]} "
          f"({sched.engine.hp.arch}, {sched.engine.n_slots} slots, "
          f"ctx {sched.engine.max_seq}, {sched.engine.device})", file=sys.stderr)
    try:
        httpd.serve_forever_thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
