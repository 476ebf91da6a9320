"""tpullm-torch-gguf-metadata: copy a GGUF with metadata edits (the JAX
package's tools/gguf_metadata.py, its flags and output; reference gguf-py
gguf_new_metadata.py / gguf_set_metadata.py).

Adds or overrides KVs (`--set KEY=VALUE`, the value a Python literal where
it parses), removes KVs, sets general.name or swaps the chat template;
every tensor payload is copied through packed, unchanged.

    python -m tpullm_torch.tools.gguf_metadata in.gguf out.gguf --set KEY=VALUE
        [--remove KEY] [--general-name NAME] [--chat-template-file FILE]
"""

from __future__ import annotations

import argparse
import ast
import sys

from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter


def _parse_value(s: str):
    """A Python literal where it parses (1, 1.5, True, [1, 2]), else the
    bare string."""
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def edit_metadata(src: str, dst: str, sets: dict, removes: list[str],
                  chat_template: str | None = None) -> dict:
    """Writes `src` to `dst` with `sets` added or overridden (after the
    file's other keys), `removes` left out and the chat template replaced;
    returns {"set", "removed", "tensors"}."""
    r = GGUFReader(src)
    arch = r.metadata.get("general.architecture", "llama")
    w = GGUFWriter(dst, architecture=arch)
    applied, removed = {}, []
    for k, v in r.metadata.items():
        if k == "general.architecture":
            continue
        if k in removes:
            removed.append(k)
            continue
        if k in sets:
            continue  # added below with its new value
        w.add_kv(k, v)
    for k, v in sets.items():
        if k == "general.architecture":
            raise ValueError("cannot change general.architecture")
        w.add_kv(k, v)
        applied[k] = v
    if chat_template is not None:
        w.set_kv("tokenizer.chat_template", chat_template)
        applied["tokenizer.chat_template"] = "<file>"
    for name, info in r.tensors.items():
        w.add_packed_tensor(name, info.shape, info.ggml_type, info.data)
    w.write()
    return {"set": applied, "removed": removed, "tensors": len(r.tensors)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-gguf-metadata")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="add/override a KV (value parsed as a Python "
                         "literal when possible; repeatable)")
    ap.add_argument("--remove", action="append", default=[], metavar="KEY")
    ap.add_argument("--general-name", default=None,
                    help="shortcut for --set general.name=...")
    ap.add_argument("--chat-template-file", default=None,
                    help="replace tokenizer.chat_template with this file's "
                         "contents")
    args = ap.parse_args(argv)
    sets = {}
    for kv in args.set:
        if "=" not in kv:
            ap.error(f"--set needs KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        sets[k] = _parse_value(v)
    if args.general_name is not None:
        sets["general.name"] = args.general_name
    tmpl = None
    if args.chat_template_file:
        with open(args.chat_template_file, encoding="utf-8") as f:
            tmpl = f.read()
    stats = edit_metadata(args.input, args.output, sets, args.remove, chat_template=tmpl)
    print(f"wrote {args.output}: set {len(stats['set'])} keys, removed "
          f"{len(stats['removed'])}, {stats['tensors']} tensors copied", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
