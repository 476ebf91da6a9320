"""Import guard: tpullm_torch and chip_smoke.py import neither JAX nor the
tpullm package (tpullm_torch keeps its own copies of what it needs), and
tpullm_torch does not import `regex` (the BPE tokenizer's patterns run on
the standard library's `re`, their property classes shipped as data; the
card's machine is not known to have `regex` in every setup, and
chip_smoke.py only reports whether it imports there) nor `aiohttp` (the
server's HTTP layer is the standard library's http.server: the card's
machine has no aiohttp). Every module of the package, the tools and the
server among them, imports with the four blocked. The port's test files
set no environment variable for good: one left set changes the JAX tests
that a worker runs after them (TPULLM_DEVICE_REPACK=1 left by a module
fixture failed two of tests/test_pipeline_infer.py's)."""

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
        banned += ("regex", "aiohttp")
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
        "sys.modules['aiohttp'] = None\n"
        "import tpullm_torch.runtime.engine, tpullm_torch.convert, tpullm_torch.models.synth\n"
        "import tpullm_torch.ops.kernels.qmm, tpullm_torch.ops.kernels.flash\n"
        "import tpullm_torch.ops.moe, tpullm_torch.models.llama, tpullm_torch.models.weights\n"
        "import tpullm_torch.models.gemma, tpullm_torch.models.registry\n"
        "import tpullm_torch.models.deepseek2, tpullm_torch.models.qwen_moe\n"
        "import tpullm_torch.models.falcon, tpullm_torch.runtime.fit\n"
        "import tpullm_torch.grammar, tpullm_torch.runtime.sampling, tpullm_torch.runtime.graph\n"
        "import tpullm_torch.runtime.state, tpullm_torch.chat, tpullm_torch.jinja\n"
        "import tpullm_torch.utils.logging, tpullm_torch.utils.console\n"
        "import tpullm_torch.grammar.json_partial\n"
        "import tpullm_torch.tools.cli, tpullm_torch.tools.perplexity, tpullm_torch.tools.bench\n"
        "import tpullm_torch.tools.tokenize, tpullm_torch.tools.compare_bench\n"
        "import tpullm_torch.runtime.batch_engine, tpullm_torch.tools.batched_bench\n"
        "import tpullm_torch.server, tpullm_torch.server.api, tpullm_torch.server.router\n"
        "import tpullm_torch.server.scheduler, tpullm_torch.server.__main__\n"
        "import tpullm_torch.runtime.speculative, tpullm_torch.runtime.ngram_cache\n"
        "import tpullm_torch.tools.lookup, tpullm_torch.tools.cvector, tpullm_torch.models.lora\n"
        "import tpullm_torch.models.bloom, tpullm_torch.models.gpt2, tpullm_torch.tools.conformance\n"
        "import tpullm_torch.models.llama4, tpullm_torch.models.phi3, tpullm_torch.ops.attention\n"
        "import tpullm_torch.models.mamba, tpullm_torch.models.jamba\n"
        "import tpullm_torch.runtime.recurrent\n"
        "import tpullm_torch.tools.gguf_dump, tpullm_torch.tools.gguf_hash\n"
        "import tpullm_torch.tools.gguf_metadata, tpullm_torch.tools.gguf_edit\n"
        "import tpullm_torch.tools.gguf_split, tpullm_torch.tools.gguf_endian\n"
        "from tpullm_torch.tokenizer import bpe\n"
        "assert bpe.regex_split(\"it's 1234\", bpe.resolve_pre('llama-bpe')['regexes']) == \\\n"
        "    ['it', \"'s\", ' ', '123', '4']\n"
        "assert not any(m in ('jax', 'regex', 'aiohttp')\n"
        "               or m.startswith(('jax.', 'tpullm.', 'regex.', 'aiohttp.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


TEST_FILES = sorted((ROOT / "tests").glob("test_torch_*.py"))


def _sets_environ(node) -> bool:
    """os.environ[...] = …, os.environ.setdefault / update (…), os.putenv (…)."""
    def is_environ(n):
        return (isinstance(n, ast.Attribute) and n.attr == "environ"
                and isinstance(n.value, ast.Name) and n.value.id == "os")
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        return any(isinstance(t, ast.Subscript) and is_environ(t.value) for t in targets)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        f = node.func
        return ((f.attr in ("setdefault", "update") and is_environ(f.value))
                or (f.attr == "putenv" and isinstance(f.value, ast.Name) and f.value.id == "os"))
    return False


@pytest.mark.parametrize("path", TEST_FILES, ids=lambda p: p.name)
def test_torch_tests_leave_the_environment_as_they_found_it(path):
    """A test file sets an environment variable through monkeypatch (or
    pytest.MonkeyPatch.context, for a module fixture), never os.environ."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [node.lineno for node in ast.walk(tree) if _sets_environ(node)]
    assert not bad, f"{path.name} sets os.environ at lines {bad}"
