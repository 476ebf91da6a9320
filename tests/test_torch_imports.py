"""Import guard: tpullm_torch and chip_smoke.py import neither JAX nor the
tpullm package (tpullm_torch keeps its own copies of what it needs)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "tpullm_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "tpullm")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_tpullm_import(path):
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
        "import tpullm_torch.runtime.engine, tpullm_torch.convert, tpullm_torch.models.synth\n"
        "import tpullm_torch.ops.kernels.qmm, tpullm_torch.ops.kernels.flash\n"
        "import tpullm_torch.ops.moe, tpullm_torch.models.llama, tpullm_torch.models.weights\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'tpullm.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
