"""tpullm-torch-gguf-edit: an interactive GGUF metadata editor (the JAX
package's tools/gguf_edit.py, its commands and output; the terminal
edition of gguf-py's gguf_editor_gui.py):

    python -m tpullm_torch.tools.gguf_edit model.gguf

commands:
    list [prefix]      metadata keys (values truncated)
    get KEY            full value
    set KEY VALUE      typed set (Python literal or bare string)
    del KEY            remove a key
    rename OLD NEW     rename a key, keeping its value
    tensors [prefix]   tensor table (name, type, shape, bytes)
    template           show tokenizer.chat_template
    save [PATH]        write (atomically; in-place by default)
    quit / q           exit (warns on unsaved changes)

Edits are staged in memory and written once with `save` through
tpullm-torch-gguf-metadata's edit_metadata (tensor payloads copied
through unchanged)."""

from __future__ import annotations

import argparse
import os
import sys

from ..gguf.reader import GGUFReader
from .gguf_metadata import _parse_value, edit_metadata


def _short(v, width: int = 72) -> str:
    s = repr(v)
    return s if len(s) <= width else s[: width - 20] + f"... ({len(s)} chars)"


class Editor:
    def __init__(self, path: str):
        self.path = path
        self.reader = GGUFReader(path)
        self.sets: dict = {}
        self.removes: list[str] = []

    def keys(self):
        """The file's keys with the staged edits applied, sorted."""
        ks = [k for k in self.reader.metadata if k not in self.removes]
        ks += [k for k in self.sets if k not in ks]
        return sorted(set(ks))

    def get(self, key):
        if key in self.sets:
            return self.sets[key]
        if key in self.removes:
            raise KeyError(key)
        return self.reader.metadata[key]

    def dirty(self) -> bool:
        return bool(self.sets or self.removes)

    def save(self, dst: str | None = None) -> dict:
        out = dst or self.path
        tmp = out + ".tmp"
        res = edit_metadata(self.path, tmp, self.sets, self.removes)
        os.replace(tmp, out)
        return res

    def run(self, inp=None, out=sys.stdout):  # noqa: C901 (a REPL's switch)
        inp = inp if inp is not None else sys.stdin

        def p(*a):
            print(*a, file=out)

        p(f"{self.path}: {len(self.reader.metadata)} metadata keys, "
          f"{len(self.reader.tensors)} tensors. Type 'help' for commands.")
        while True:
            print("gguf> ", end="", file=out, flush=True)
            line = inp.readline()
            if not line:
                break
            parts = line.strip().split(None, 2)
            if not parts:
                continue
            cmd = parts[0].lower()
            try:
                if cmd in ("q", "quit", "exit"):
                    if self.dirty():
                        p("unsaved changes discarded "
                          f"({len(self.sets)} set, {len(self.removes)} removed)")
                    break
                elif cmd == "help":
                    p(__doc__.split("commands:")[1].split("Edits are")[0])
                elif cmd == "list":
                    pre = parts[1] if len(parts) > 1 else ""
                    for k in self.keys():
                        if k.startswith(pre):
                            p(f"  {k} = {_short(self.get(k))}")
                elif cmd == "get":
                    p(repr(self.get(parts[1])))
                elif cmd == "set":
                    key, val = parts[1], _parse_value(parts[2] if len(parts) > 2 else "")
                    self.sets[key] = val
                    if key in self.removes:
                        self.removes.remove(key)
                    p(f"staged: {key} = {_short(val)}")
                elif cmd == "del":
                    key = parts[1]
                    self.get(key)  # raises if absent
                    self.sets.pop(key, None)
                    self.removes.append(key)
                    p(f"staged removal: {key}")
                elif cmd == "rename":
                    old, new = parts[1], parts[2]
                    self.sets[new] = self.get(old)
                    self.sets.pop(old, None)
                    self.removes.append(old)
                    p(f"staged: {old} -> {new}")
                elif cmd == "tensors":
                    pre = parts[1] if len(parts) > 1 else ""
                    for name, ti in self.reader.tensors.items():
                        if name.startswith(pre):
                            p(f"  {name:48s} {ti.ggml_type.name:8s} "
                              f"{tuple(ti.shape)!s:20s} {ti.n_bytes} B")
                elif cmd == "template":
                    p(self.get("tokenizer.chat_template"))
                elif cmd == "save":
                    dst = parts[1] if len(parts) > 1 else None
                    res = self.save(dst)
                    p(f"wrote {dst or self.path}: {len(res['set'])} set, "
                      f"{len(res['removed'])} removed, {res['tensors']} tensors copied")
                    if dst is None:
                        self.__init__(self.path)  # reload the new file
                else:
                    p(f"unknown command {cmd!r} — try 'help'")
            except KeyError as e:
                p(f"no such key: {e}")
            except IndexError:
                p("missing argument — try 'help'")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpullm-torch-gguf-edit",
        description="Interactive GGUF metadata editor (≡ gguf_editor_gui.py, terminal edition)")
    ap.add_argument("model")
    args = ap.parse_args(argv)
    Editor(args.model).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
