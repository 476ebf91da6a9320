"""tpullm-torch: generation CLI (≡ reference tools/cli + tools/completion),
the JAX package's tools/cli.py on the port's Engine.

Single-prompt completion and interactive chat. Flags mirror the reference's
common ones (-m/-p/-n/-c/--temp/...); every flag also reads a TPULLM_* env
fallback (≡ LLAMA_ARG_* convention). It runs on the card (`--device cuda`,
the default) unless asked for the CPU (`--device cpu`); the completion's
tokens come from `Engine.generate_tokens`: a prefill, then logits-only
decode steps (on the card CUDA-graph replays) through the host Sampler.
With a draft model (-md) or n-gram lookup (--spec-ngram) they come from
`generate_speculative` instead: up to --draft-max drafts a round, verified
in one forward (on the card a graph replay).

    python -m tpullm_torch.tools.cli -m model.gguf -p "Once upon a time" -n 64
    python -m tpullm_torch.tools.cli -m model.gguf -md draft.gguf -p "..." -n 64 -v

--swa-full gives an iSWA model (gemma2, gemma3) a full-size cache for its
sliding-window layers in place of the ring. --grp-attn-n N > 1 is
self-extend: RoPE positions slot // N (Engine's grp_attn_n). The Hugging
Face download flags are left out: the port's machines have no network.
"""

from __future__ import annotations

import argparse
import os
import sys

def _env(name, default=None):
    return os.environ.get(f"TPULLM_{name.upper().replace('-', '_')}", default)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpullm-torch",
                                 description="LLM inference on an NVIDIA GPU")
    ap.add_argument("-m", "--model", default=_env("model"))
    ap.add_argument("--device", default=_env("device", "cuda"),
                    help="cuda (the hand-written kernels) or cpu (their plain versions)")
    ap.add_argument("-p", "--prompt", default=None)
    # logging/verbosity family (≡ common/arg.cpp --log-* flags)
    ap.add_argument("--log-verbosity", type=int, default=None,
                    help="0=output 1=error 2=warn 3=info 4=debug")
    ap.add_argument("--log-colors", choices=["auto", "on", "off"], default=None)
    ap.add_argument("--log-timestamps", action="store_true")
    ap.add_argument("--log-prefix", action="store_true")
    ap.add_argument("--log-file", default=None)
    ap.add_argument("-n", "--n-predict", type=int, default=int(_env("n_predict", 128)))
    ap.add_argument("-c", "--ctx-size", type=int, default=int(_env("ctx_size", 2048)))
    ap.add_argument("--temp", type=float, default=float(_env("temp", 0.8)))
    ap.add_argument("--top-k", type=int, default=int(_env("top_k", 40)))
    ap.add_argument("--top-p", type=float, default=float(_env("top_p", 0.95)))
    ap.add_argument("--min-p", type=float, default=float(_env("min_p", 0.05)))
    ap.add_argument("--seed", type=int, default=int(_env("seed", -1)))
    ap.add_argument("--repeat-penalty", type=float, default=1.0)
    ap.add_argument("--repeat-last-n", type=int, default=64)
    ap.add_argument("--mode", choices=["auto", "quant", "dense"], default="auto",
                    help="weight path: packed planes on the qmm kernels, or dequantized "
                         "bf16 through torch.matmul")
    ap.add_argument("-md", "--model-draft", default=_env("model_draft"),
                    help="draft model for speculative decoding")
    ap.add_argument("--draft-max", type=int, default=int(_env("draft_max", 5)),
                    help="max draft tokens per round")
    ap.add_argument("--spec-ngram", action="store_true",
                    help="model-free n-gram speculation")
    ap.add_argument("--prompt-cache", default=None,
                    help="session file: restore matching prompt prefix, save after")
    ap.add_argument("--override-kv", action="append", default=[],
                    metavar="KEY=TYPE:VALUE",
                    help="override GGUF metadata, e.g. "
                         "llama.rope.freq_base=float:1000000 (≡ llama.cpp)")
    ap.add_argument("--preset", default=_env("preset"),
                    help="ini-style preset file of flag defaults")
    ap.add_argument("--grp-attn-n", type=int, default=1,
                    help="self-extend group size: rope positions compress to "
                         "slot//N (= passkey --grp-attn-n)")
    ap.add_argument("--swa-full", action="store_true",
                    help="full-size KV cache for SWA layers (disable the iSWA ring; "
                         "≡ llama.cpp --swa-full)")
    ap.add_argument("--cache-type-kv", default=None, choices=["f16", "bf16", "f32", "q8_0"],
                    help="KV cache storage type (≡ --cache-type-k/v)")
    ap.add_argument("--chat", action="store_true", help="interactive chat")
    ap.add_argument("--no-display-prompt", action="store_true")
    ap.add_argument("--verbose", "-v", action="store_true")
    return ap


def parse_kv_overrides(specs: list[str]) -> dict:
    """key=type:value → typed metadata dict (≡ common/arg.cpp --override-kv)."""
    out = {}
    for spec in specs:
        key, _, rest = spec.partition("=")
        typ, _, val = rest.partition(":")
        if not val and typ:  # bare value defaults to str
            typ, val = "str", typ
        if typ == "int":
            out[key] = int(val)
        elif typ == "float":
            out[key] = float(val)
        elif typ == "bool":
            out[key] = val.lower() in ("1", "true", "yes", "on")
        elif typ == "str":
            out[key] = val
        else:
            raise ValueError(f"bad --override-kv type {typ!r} (int|float|bool|str)")
    return out


def apply_preset(args, parser, argv):
    """Load ini-style `key = value` defaults that CLI flags still override
    (≡ common/preset.cpp)."""
    import configparser

    cp = configparser.ConfigParser()
    with open(args.preset) as f:
        cp.read_string("[preset]\n" + f.read())
    # re-parse: preset values become defaults, explicit CLI args win
    parser.set_defaults(**{key.replace("-", "_"): val for key, val in cp.items("preset")})
    return parser.parse_args(argv)


def make_engine(args):
    from ..runtime.engine import Engine

    if not args.model:
        raise SystemExit("-m/--model is required")
    kw = {"kv_dtype": args.cache_type_kv} if args.cache_type_kv else {}
    return Engine(args.model, device=args.device, mode=args.mode, max_seq=int(args.ctx_size),
                  override_kv=parse_kv_overrides(args.override_kv or []),
                  swa_full=args.swa_full, grp_attn_n=int(args.grp_attn_n), **kw)


def make_sampler(args):
    from ..runtime.sampling import Sampler, SamplerParams

    seed = args.seed if args.seed >= 0 else 0xFFFFFFFF
    return Sampler(SamplerParams(
        temp=args.temp, top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        seed=seed, penalty_repeat=args.repeat_penalty,
        penalty_last_n=args.repeat_last_n,
    ))


def run_completion(args) -> int:
    eng = make_engine(args)
    if args.prompt_cache and eng.arch.recurrent:  # refused before anything is generated
        from ..runtime.state import STATE_REFUSED

        raise SystemExit(f"--prompt-cache: {STATE_REFUSED}")
    sampler = make_sampler(args)
    prompt = args.prompt if args.prompt is not None else sys.stdin.read()
    if not args.no_display_prompt:
        sys.stdout.write(prompt)
        sys.stdout.flush()
    ids = eng.tokenizer.tokenize(prompt, add_special=True, parse_special=True)

    # session file (≡ completion --prompt-cache, GGSN session semantics):
    # restore the cached state when it is a prefix of this prompt, feed only
    # the tail, and re-save the extended state afterwards. The state is
    # written into the engine's cache in place (runtime/state.py).
    ids_tail = ids
    if args.prompt_cache and os.path.exists(args.prompt_cache):
        from ..runtime.state import load_state

        try:
            saved = load_state(eng, args.prompt_cache)
            n = 0
            for a, b in zip(saved, ids):
                if a != b:
                    break
                n += 1
            n = min(n, len(ids) - 1, eng.n_past)
            if n > 0:
                eng.n_past = n
                ids_tail = ids[n:]
                print(f"[prompt cache: reused {n} tokens]", file=sys.stderr)
            else:
                eng.reset()
        except ValueError as e:
            print(f"[prompt cache ignored: {e}]", file=sys.stderr)
            eng.reset()
    if args.model_draft or args.spec_ngram:
        # the speculative path manages its own cache: a restored state is dropped
        eng.reset()
        from ..runtime.engine import Engine
        from ..runtime.speculative import (DraftModelSpeculator, NgramSpeculator,
                                           generate_speculative)

        if args.model_draft:
            spec = DraftModelSpeculator(
                Engine(args.model_draft, device=args.device, mode=args.mode,
                       max_seq=int(args.ctx_size), swa_full=args.swa_full),
                n_draft=int(args.draft_max))
        else:
            spec = NgramSpeculator(n_draft=int(args.draft_max))
        out, stats = generate_speculative(eng, spec, ids, max_new_tokens=args.n_predict,
                                          sampler=sampler)
        sys.stdout.write(eng.tokenizer.detokenize(out))
        if args.verbose:
            print(f"\nspeculative: {stats.n_rounds} rounds, {stats.n_drafted} drafted, "
                  f"accept {stats.accept_rate:.0%}", file=sys.stderr)
    else:
        out_toks = []
        for tok in eng.generate_tokens(ids_tail, max_new_tokens=args.n_predict,
                                       sampler=sampler):
            out_toks.append(tok)
            sys.stdout.write(eng.tokenizer.detokenize([tok]))
            sys.stdout.flush()
        if args.prompt_cache:
            from ..runtime.state import save_state

            save_state(eng, args.prompt_cache, tokens=ids + out_toks[:-1])
            print(f"[prompt cache: saved {eng.n_past} tokens]", file=sys.stderr)
    sys.stdout.write("\n")
    if args.verbose:
        print(eng.perf.report(), file=sys.stderr)
    return 0


def run_chat(args) -> int:
    from ..chat import apply_chat_template
    from ..utils.console import Console
    from ..utils.logging import main_log

    eng = make_engine(args)
    sampler = make_sampler(args)
    messages = []
    con = Console()
    mlog = main_log()
    print("tpullm-torch chat — empty line or /exit to quit", file=sys.stderr)
    while True:
        mlog.pause()  # raw console I/O owns the terminal (≡ common_log_pause)
        try:
            user = con.readline("> ")
        except KeyboardInterrupt:
            break
        finally:
            mlog.resume()
        if not user.strip() or user.strip() == "/exit":
            break
        messages.append({"role": "user", "content": user})
        prompt = apply_chat_template(
            eng.tokenizer.vocab.chat_template, messages, add_generation_prompt=True
        )
        eng.reset()  # the cache is rewritten in place from slot 0
        ids = eng.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
        pieces = []
        for tok in eng.generate_tokens(ids, max_new_tokens=args.n_predict, sampler=sampler):
            piece = eng.tokenizer.detokenize([tok])
            pieces.append(piece)
            con.put(piece)  # UTF-8-safe: buffers split codepoints
        con.flush_partial()
        sys.stdout.write("\n")
        messages.append({"role": "assistant", "content": "".join(pieces)})
    con.cleanup()
    return 0


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    from ..utils.logging import main_log

    _ml = main_log()
    if args.log_verbosity is not None:
        _ml.set_verbosity(args.log_verbosity)
    if args.log_colors is not None:
        _ml.set_colors(args.log_colors == "on" or (
            args.log_colors == "auto" and sys.stderr.isatty()))
    if args.log_timestamps:
        _ml.set_timestamps(True)
    if args.log_prefix:
        _ml.set_prefix(True)
    if args.log_file:
        _ml.set_file(args.log_file)
    if args.preset:
        args = apply_preset(args, parser, argv)
    if args.chat:
        return run_chat(args)
    return run_completion(args)


if __name__ == "__main__":
    sys.exit(main())
