"""The code-point runs of the BPE patterns' property classes as the `regex`
module has them, and the data file the port ships them in
(tpullm_torch/tokenizer/unicode_props.npz).

The port may not import `regex`, so its tokenizer reads these runs as data,
the way quant/iq_grids.npz carries the codebooks. The tests rebuild them
from the installed `regex` over every code point and require equality.
Regenerate after a `regex` upgrade:

    python tests/torch_unicode_props.py
"""

import sys
from pathlib import Path

import numpy as np
import regex

DATA = Path(__file__).resolve().parents[1] / "tpullm_torch" / "tokenizer" / "unicode_props.npz"
# the first code point of each Unicode version after 15.0 that `regex`'s
# tables may have: U+20C1 SAUDI RIYAL SIGN (17.0), U+1C89 CYRILLIC CAPITAL
# LETTER TJE (16.0)
_VERSION_PROBES = (("17.0.0", "⃁", r"\p{S}"), ("16.0.0", "Ᲊ", r"\p{L}"),
                   ("15.0.0", "a", r"\p{L}"))


def all_code_points() -> str:
    return "".join(chr(c) for c in range(sys.maxunicode + 1))


def regex_runs(name: str, text: str | None = None) -> np.ndarray:
    """[n, 2] int32 (lo, hi) runs of \\p{name} in `regex` ("space": `\\s`,
    White_Space), over every code point: the spans of the maximal matches
    of the class over all code points in order."""
    pat = r"\s+" if name == "space" else rf"\p{{{name}}}+"
    text = all_code_points() if text is None else text
    return np.asarray([(m.start(), m.end() - 1) for m in regex.finditer(pat, text)],
                      dtype=np.int32).reshape(-1, 2)


def regex_unicode_version() -> str:
    for version, ch, prop in _VERSION_PROBES:
        if regex.fullmatch(prop, ch):
            return version
    raise RuntimeError("regex's Unicode tables are older than 15.0")


def write(names) -> None:
    text = all_code_points()
    np.savez_compressed(DATA, regex_version=np.asarray(regex.__version__),
                        unicode_version=np.asarray(regex_unicode_version()),
                        **{name: regex_runs(name, text) for name in names})


if __name__ == "__main__":
    sys.path.insert(0, str(DATA.parents[2]))
    from tpullm_torch.tokenizer.bpe import PROPERTY_CLASSES

    write([*PROPERTY_CLASSES, "space"])
    print(f"wrote {DATA}")
