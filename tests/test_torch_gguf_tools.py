"""The port's GGUF tools (tpullm_torch/tools/gguf_{dump,hash,metadata,edit,
split,endian}.py) against the JAX package's on the same files: the same
stdout and stderr, the same written bytes. The port's reader opens a split
model through its first shard as the whole file (an Engine on it gives the
whole file's logits), and raises on a missing shard or a tensor named
twice. The endian round trip is byte-equal for every type of the port's
kernels (ops/qmatmul.py _SCHEMA), the types the JAX tool refuses among
them.

Files: the port's synthetic `tiny` at Q4_K_M (Q4_K, Q6_K and f32 tensors,
an SPM vocab) and the JAX package's f32 tiny llama
(tpullm/models/testing.py make_tiny_llama_gguf)."""

import io
import json
import shutil
import struct
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.models.testing import make_tiny_llama_gguf
from tpullm.tools import gguf_dump as jdump
from tpullm.tools import gguf_edit as jedit
from tpullm.tools import gguf_endian as jendian
from tpullm.tools import gguf_hash as jhash
from tpullm.tools import gguf_metadata as jmeta
from tpullm.tools import gguf_split as jsplit

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.gguf.reader import GGUFFormatError, GGUFReader
from tpullm_torch.gguf.writer import GGUFWriter
from tpullm_torch.models.synth import make_synthetic_llama_gguf, random_packed
from tpullm_torch.ops.qmatmul import _SCHEMA
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.tools import gguf_dump, gguf_edit, gguf_endian, gguf_hash, gguf_metadata, \
    gguf_split

FILES = ("synth", "jax")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gguf_tools")
    return {"synth": str(make_synthetic_llama_gguf(d / "tiny.gguf", shape="tiny", seed=0)),
            "jax": str(make_tiny_llama_gguf(d / "jax.gguf", n_embd=256, n_head=4, n_head_kv=2,
                                            n_ff=256, n_layer=2))}


def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("flags", [[], ["--json"], ["--no-tensors"], ["--json", "--no-tensors"]])
@pytest.mark.parametrize("name", FILES)
def test_dump_prints_what_jax_prints(files, name, flags):
    got = _run(gguf_dump.main, [files[name], *flags])
    assert got == _run(jdump.main, [files[name], *flags])
    if "--json" in flags:
        assert json.loads(got[1])["version"] == 3


@pytest.mark.parametrize("flags", [[], ["--all"], ["--sha256", "--no-layer"], ["--sha1"],
                                   ["--blake2b64", "--sha256"]])
def test_hash_prints_what_jax_prints(files, flags):
    path = files["synth"]
    assert _run(gguf_hash.main, [path, *flags]) == _run(jhash.main, [path, *flags])
    out = io.StringIO()
    got = gguf_hash.hash_gguf(path, ["sha256"], out=out)
    assert got == jhash.hash_gguf(path, ["sha256"], out=io.StringIO())


@pytest.mark.parametrize("name", FILES)
def test_metadata_writes_what_jax_writes(files, name, tmp_path):
    tmpl = tmp_path / "tmpl.jinja"
    tmpl.write_text("{% for m in messages %}{{ m.content }}{% endfor %}", encoding="utf-8")
    argv = ["--set", "custom.answer=42", "--set", "custom.list=[1, 2, 5000000000]",
            "--set", "custom.word=hello", "--remove", "tokenizer.ggml.add_bos_token",
            "--general-name", "renamed", "--chat-template-file", str(tmpl)]
    got = _run(gguf_metadata.main, [files[name], str(tmp_path / "port.gguf"), *argv])
    want = _run(jmeta.main, [files[name], str(tmp_path / "jax.gguf"), *argv])
    assert got[0] == want[0] == 0 and got[1:] == (
        want[1], want[2].replace(str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")))
    assert _bytes(tmp_path / "port.gguf") == _bytes(tmp_path / "jax.gguf")
    r = GGUFReader(tmp_path / "port.gguf")
    assert r.metadata["general.name"] == "renamed" and r.metadata["custom.answer"] == 42
    assert list(r.metadata["custom.list"]) == [1, 2, 5000000000]
    assert "tokenizer.ggml.add_bos_token" not in r.metadata


def test_writer_set_kv_replaces_a_key(tmp_path):
    w = GGUFWriter(tmp_path / "kv.gguf", architecture="llama")
    w.add_kv("a", 1)
    w.add_kv("b", "x")
    w.set_kv("a", 2.5)
    w.write()
    r = GGUFReader(tmp_path / "kv.gguf")
    assert list(r.metadata) == ["general.architecture", "b", "a"] and r.metadata["a"] == 2.5


EDIT_SCRIPT = "\n".join([
    "list general.", "get general.name", "set general.name edited-model",
    "set custom.answer 42", "set custom.floats [1.5, 2.5]",
    "rename general.name general.renamed", "del tokenizer.ggml.add_bos_token",
    "get no.such.key", "set", "tensors blk.0.attn", "template", "bogus", "save", "list custom",
    "set custom.later 1", "quit"]) + "\n"


@pytest.mark.parametrize("name", FILES)
def test_edit_session_as_jax(files, name, tmp_path):
    """One REPL session on a copy of the file in each package: the same
    transcript (the file's path aside) and the same saved bytes."""
    outs = []
    for tag, editor in (("port", gguf_edit.Editor), ("jax", jedit.Editor)):
        path = tmp_path / f"{tag}.gguf"
        shutil.copyfile(files[name], path)
        out = io.StringIO()
        editor(str(path)).run(inp=io.StringIO(EDIT_SCRIPT), out=out)
        outs.append(out.getvalue().replace(str(path), "<path>"))
    assert outs[0] == outs[1] and "staged: general.name" in outs[0]
    assert _bytes(tmp_path / "port.gguf") == _bytes(tmp_path / "jax.gguf")
    assert GGUFReader(tmp_path / "port.gguf").metadata["general.renamed"] == "edited-model"


def test_split_writes_what_jax_writes_and_loads_as_the_whole(files, tmp_path):
    """Shards of at most 5 tensors: the same files as the JAX tool's, the
    same stdout and stderr (paths aside); the port's reader on shard 1 has
    the whole file's tensors (names, types, shapes, bytes) and an Engine on
    it the whole file's logits; the merge is the JAX merge byte for byte."""
    src = files["synth"]
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    argv = ["--split-max-tensors", "5", src]
    got = _run(gguf_split.main, [*argv, str(tmp_path / "p" / "m")])
    want = _run(jsplit.main, [*argv, str(tmp_path / "j" / "m")])
    assert got[:2] == want[:2] and got[2].replace("/p/", "/j/") == want[2]
    shards = sorted((tmp_path / "p").iterdir())
    assert len(shards) > 2 and shards[0].name == f"m-00001-of-{len(shards):05d}.gguf"
    for p in shards:
        assert _bytes(p) == _bytes(tmp_path / "j" / p.name)

    whole, split = GGUFReader(src), GGUFReader(shards[0])
    assert list(split.tensors) == list(whole.tensors) and len(split._shards) == len(shards) - 1
    for name, t in whole.tensors.items():
        s = split.tensors[name]
        assert (s.ggml_type, s.shape) == (t.ggml_type, t.shape)
        assert bytes(s.data) == bytes(t.data)
    ids = [1, 5, 9, 12, 7, 3]
    a = Engine(src, device="cpu", max_seq=64).prefill(ids)
    b = Engine(str(shards[0]), device="cpu", max_seq=64).prefill(ids)
    np.testing.assert_array_equal(a, b)

    got = _run(gguf_split.main, ["--merge", str(shards[0]), str(tmp_path / "pm.gguf")])
    want = _run(jsplit.main, ["--merge", str(tmp_path / "j" / shards[0].name),
                              str(tmp_path / "jm.gguf")])
    assert got[:2] == want[:2]
    assert _bytes(tmp_path / "pm.gguf") == _bytes(tmp_path / "jm.gguf")
    assert "split.count" not in GGUFReader(tmp_path / "pm.gguf").metadata


def test_split_model_refuses_a_missing_shard_and_a_duplicate(files, tmp_path):
    paths = gguf_split.split_model(files["synth"], str(tmp_path / "m"), max_tensors=8,
                                   verbose=False)
    assert len(paths) >= 3
    moved = tmp_path / "away.gguf"
    shutil.move(paths[1], moved)
    with pytest.raises(GGUFFormatError, match="missing shard"):
        GGUFReader(paths[0])
    # shard 2 written again holding a tensor of shard 1
    w = GGUFWriter(paths[1], architecture="llama")
    w.add_kv("split.no", 1)
    first = next(iter(GGUFReader(files["synth"]).tensors.values()))
    w.add_packed_tensor(first.name, first.shape, first.ggml_type, first.data)
    w.write()
    with pytest.raises(GGUFFormatError, match="duplicate tensor"):
        GGUFReader(paths[0])


def test_split_runs_the_engine_off_shard_one(files, tmp_path):
    """tpullm-torch-gguf-split on the JAX f32 file: greedy ids of the port's
    Engine on shard 1 equal those on the whole file."""
    paths = gguf_split.split_model(files["jax"], str(tmp_path / "m"), max_tensors=4,
                                   verbose=False)
    kw = dict(device="cpu", max_seq=64, mode="dense", dtype=torch.float32,
              kv_dtype=torch.float32)
    prompt = [1, 5, 9, 12, 7]
    want = Engine(files["jax"], **kw).generate_tokens_device(prompt, 6, stop_on_eog=False)
    assert Engine(paths[0], **kw).generate_tokens_device(prompt, 6, stop_on_eog=False) == want


@pytest.mark.parametrize("name", FILES)
def test_endian_writes_what_jax_writes(files, name, tmp_path):
    """To big-endian: the same bytes and stdout as the JAX tool; again to
    big a no-op; back to little the source byte for byte."""
    src = files[name]
    got = _run(gguf_endian.main, [src, "big", "-o", str(tmp_path / "pbe.gguf")])
    want = _run(jendian.main, [src, "big", "-o", str(tmp_path / "jbe.gguf")])
    assert got[0] == want[0] == 0
    assert got[1].replace("pbe", "jbe") == want[1] and got[2] == want[2]
    be = _bytes(tmp_path / "pbe.gguf")
    assert be == _bytes(tmp_path / "jbe.gguf") and be != _bytes(src)
    assert struct.unpack_from(">I", be, 4)[0] == 3
    noop = gguf_endian.convert_endian(str(tmp_path / "pbe.gguf"), str(tmp_path / "n.gguf"),
                                      "big", verbose=False)
    assert noop.get("noop")
    gguf_endian.convert_endian(str(tmp_path / "pbe.gguf"), str(tmp_path / "back.gguf"),
                               "little", verbose=False)
    assert _bytes(tmp_path / "back.gguf") == _bytes(src)


@pytest.mark.parametrize("gtype", sorted(_SCHEMA, key=int), ids=lambda t: t.name)
def test_endian_round_trip_every_kernel_type(gtype, tmp_path):
    """A file of one `gtype` tensor (random blocks) and an f32 one: to big
    (in place) and back is byte-equal to the source; the big file differs
    but for MXFP4, whose blocks hold no multi-byte field. The JAX tool
    takes the legacy and K-quant types (its bytes are the port's on them)
    and refuses the others."""
    rng = np.random.default_rng(int(gtype))
    src = tmp_path / "src.gguf"
    w = GGUFWriter(src, architecture="llama")
    w.add_kv("general.alignment", 64)
    w.add_kv("custom.ints", np.arange(5, dtype=np.int32))
    w.add_packed_tensor("w", (256, 8), gtype, random_packed(rng, gtype, 256 * 8))
    w.add_tensor("v", rng.standard_normal(16).astype(np.float32))
    w.write()
    be = tmp_path / "be.gguf"
    shutil.copyfile(src, be)
    res = gguf_endian.convert_endian(str(be), str(be), "big", verbose=False)
    assert res == {"tensors": 2, "order": "big"}
    w_bytes = GGUFReader(src).tensors["w"].data.tobytes()
    src_b, be_b = _bytes(src), _bytes(be)
    start, n = src_b.index(w_bytes), len(w_bytes)
    w_src, w_be = (b[start:start + n] for b in (src_b, be_b))
    assert (w_src == w_be) == (gtype == GGMLType.MXFP4)
    gguf_endian.convert_endian(str(be), str(be), "little", verbose=False)
    assert _bytes(be) == src_b
    if gtype in jendian._F16_FIELDS:
        jendian.convert_endian(str(src), str(tmp_path / "j.gguf"), "big", verbose=False)
        assert _bytes(tmp_path / "j.gguf") == be_b
    else:
        with pytest.raises(NotImplementedError):
            jendian.convert_endian(str(src), str(tmp_path / "j.gguf"), "big", verbose=False)


def test_fit_reads_a_split_model_as_the_whole(files, tmp_path):
    """runtime/fit.py on shard 1: the whole file's weight and cache bytes."""
    from tpullm_torch.runtime import fit

    paths = gguf_split.split_model(files["synth"], str(tmp_path / "m"), max_tensors=6,
                                   verbose=False)
    whole, split = GGUFReader(files["synth"]), GGUFReader(paths[0])
    assert fit.weight_bytes(split) == fit.weight_bytes(whole) > 0
    assert fit.cache_bytes(split, "f16", 512) == fit.cache_bytes(whole, "f16", 512)
