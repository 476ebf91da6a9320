"""tpullm-torch-tokenize: tokenizer CLI (≡ reference tools/tokenize), the
JAX package's tools/tokenize.py on the port's tokenizers. It reads only the
GGUF's vocab, so it needs no card.

    python -m tpullm_torch.tools.tokenize -m model.gguf -p "Hello world" --ids
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-tokenize")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default=None)
    ap.add_argument("-f", "--file", default=None)
    ap.add_argument("--ids", action="store_true", help="ids only, one line")
    ap.add_argument("--no-bos", action="store_true")
    ap.add_argument("--no-parse-special", action="store_true")
    ap.add_argument("--show-count", action="store_true")
    args = ap.parse_args(argv)

    from .. import tokenizer as tokenizer_mod
    from ..gguf.reader import GGUFReader

    text = args.prompt
    if text is None and args.file:
        with open(args.file, encoding="utf-8", errors="replace") as f:
            text = f.read()
    if text is None:
        text = sys.stdin.read()

    tok = tokenizer_mod.from_gguf(GGUFReader(args.model))
    ids = tok.tokenize(text, add_special=not args.no_bos,
                       parse_special=not args.no_parse_special)
    if args.ids:
        print(ids)
    else:
        for tid in ids:
            piece = tok.vocab.tokens[tid]
            print(f"{tid:>8} -> {piece!r}")
    if args.show_count:
        print(f"Total number of tokens: {len(ids)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
