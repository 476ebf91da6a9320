"""Import guard: tpullm_torch and chip_smoke.py import neither JAX nor the
tpullm package (tpullm_torch keeps its own copies of what it needs), and
tpullm_torch does not import `regex` (the BPE tokenizer's patterns run on
the standard library's `re`; the card's machine is not known to have
`regex`, and chip_smoke.py only reports whether it imports there)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "tpullm_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden_in(path: Path):
    banned = ("jax", "jaxlib", "tpullm")
    if ROOT / "tpullm_torch" in path.parents:
        banned += ("regex",)
    return lambda module: module.split(".")[0] in banned


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_tpullm_import(path):
    _forbidden = _forbidden_in(path)
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


def test_engine_imports_with_jax_and_tpullm_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpullm'] = None\n"
        "sys.modules['regex'] = None\n"
        "import tpullm_torch.runtime.engine, tpullm_torch.convert, tpullm_torch.models.synth\n"
        "import tpullm_torch.ops.kernels.qmm, tpullm_torch.ops.kernels.flash\n"
        "import tpullm_torch.ops.moe, tpullm_torch.models.llama, tpullm_torch.models.weights\n"
        "import tpullm_torch.grammar, tpullm_torch.runtime.sampling, tpullm_torch.runtime.graph\n"
        "from tpullm_torch.tokenizer import bpe\n"
        "assert bpe.regex_split(\"it's 1234\", bpe.resolve_pre('llama-bpe')['regexes']) == \\\n"
        "    ['it', \"'s\", ' ', '123', '4']\n"
        "assert not any(m in ('jax', 'regex') or m.startswith(('jax.', 'tpullm.', 'regex.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
