"""Port parity of the tools that drive the engine: the port's cli
(completion, prompt cache, --override-kv, --preset), perplexity / KLD /
multiple-choice scoring, bench rows, tokenize and compare-bench against
the JAX package's tools, on the `tiny` and `tiny-moe` synthetic GGUFs that
both packages load (the JAX one through its device repack, the load the
port mirrors). The port's tools run with `--device cpu` (the kernels'
plain versions).

The tiny models are chaotic (attention scores up to ≈ 960, MoE routing
margins of 1e-3): each prompt is one on which no discrete decision flips
between the packages. The tiny dense model's NLL is ≈ 1.1e3 a token, past
f64's exp: its perplexity is inf in the port (llama.cpp's std::exp) where
the JAX tool raises OverflowError; its scores are held through the sums of
choice_logprob.
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.runtime.engine import Engine as JEngine
from tpullm.tools import bench as jbench
from tpullm.tools import cli as jcli
from tpullm.tools import compare_bench as jcompare
from tpullm.tools import perplexity as jppl
from tpullm.tools import tokenize as jtokenize

from tpullm_torch.models.synth import PRESETS, make_synthetic_llama_gguf
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.tools import bench, cli, compare_bench, perplexity, tokenize

SHAPES = ("tiny", "tiny-moe")
# completion prompts on which neither package's greedy or sampled draws flip
PROMPTS = {"tiny": "the quick brown fox", "tiny-moe": "hello world"}
# tiny-moe's sampled draws flip between the packages on "hello world" at
# seed 7 (its distributions are flat: a draw lands within the logits'
# bf16 differences of a boundary), not on this prompt
MOE_SAMPLED_PROMPT = "a lazy dog and a quick brown fox jumped over the world"
CORPUS = "the quick brown fox jumps over the lazy dog hello world " * 30
# relative tolerances: PPL / choice scores of the default weights and the
# bf16 cache (their logits agree to the slice tests' NMSE 1e-3, whose
# relative error is ≈ 3e-2 at most on a row); dense f32 weights and an f32
# cache, where only the order of f32 sums differs
RTOL_AUTO = 3e-2
RTOL_F32 = 1e-4


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    return {shape: str(make_synthetic_llama_gguf(d / f"{shape}.gguf", shape=shape, seed=0))
            for shape in SHAPES}


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    """The JAX Engines load through the JAX package's device repack."""
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


def _run(main, argv, stdin: str | None = None) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if stdin is None:
            rc = main(argv)
        else:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr("sys.stdin", io.StringIO(stdin))
                rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("shape,prompt,sampling", [
    ("tiny", PROMPTS["tiny"], ["--temp", "0"]),
    ("tiny", PROMPTS["tiny"], ["--temp", "0.8", "--seed", "7"]),
    ("tiny-moe", PROMPTS["tiny-moe"], ["--temp", "0"]),
    ("tiny-moe", MOE_SAMPLED_PROMPT, ["--temp", "0.8", "--seed", "7"]),
], ids=["tiny-greedy", "tiny-temp0.8-seed7", "tiny-moe-greedy", "tiny-moe-temp0.8-seed7"])
def test_cli_completion_as_jax(ggufs, shape, prompt, sampling):
    """The completion's stdout (prompt, tokens, newline) equal to the JAX
    cli's: greedy, and through the Sampler chain from one seed."""
    argv = ["-m", ggufs[shape], "-p", prompt, "-n", "10", "-c", "64",
            "--repeat-penalty", "1.1", *sampling]
    rc, got, _ = _run(cli.main, argv + ["--device", "cpu"])
    rc_j, want, _ = _run(jcli.main, argv)
    assert rc == rc_j == 0 and got == want and got.startswith(prompt)


def test_prompt_cache_reuses_and_repeats(ggufs, tmp_path):
    """--prompt-cache twice: the second run restores the saved prefix
    (reused), and its stdout is the first's; the JAX cli reads the port's
    file and prints the same."""
    cache = tmp_path / "session.npz"
    argv = ["-m", ggufs["tiny-moe"], "-p", PROMPTS["tiny-moe"], "-n", "6", "--temp", "0",
            "-c", "64", "--prompt-cache", str(cache)]
    rc1, out1, err1 = _run(cli.main, argv + ["--device", "cpu"])
    rc2, out2, err2 = _run(cli.main, argv + ["--device", "cpu"])
    assert rc1 == rc2 == 0 and "saved" in err1 and "reused" in err2 and out2 == out1
    n = int(re.search(r"reused (\d+) tokens", err2).group(1))
    assert n > 0
    rc3, out3, err3 = _run(jcli.main, argv)
    assert rc3 == 0 and "reused" in err3 and out3 == out1


def test_override_kv_and_preset(ggufs, tmp_path):
    """tests/test_tools.py's case on the port: typed overrides, an Engine
    whose metadata they change, and a preset file of flag defaults."""
    specs = ["llama.rope.freq_base=float:99.5", "x.flag=bool:true", "x.n=int:7", "x.s=str:hi"]
    ov = cli.parse_kv_overrides(specs)
    assert ov == jcli.parse_kv_overrides(specs) == {"llama.rope.freq_base": 99.5,
                                                    "x.flag": True, "x.n": 7, "x.s": "hi"}
    eng = Engine(ggufs["tiny"], device="cpu", mode="dense", max_seq=64,
                 override_kv={"llama.rope.freq_base": 99.5})
    assert eng.hp.rope.freq_base == 99.5
    preset = tmp_path / "p.ini"
    preset.write_text("n-predict = 3\ntemp = 0\nmode = dense\n")
    argv = ["-m", ggufs["tiny"], "-p", "the quick", "--preset", str(preset),
            "--no-display-prompt"]
    rc, got, _ = _run(cli.main, argv + ["--device", "cpu"])
    rc_j, want, _ = _run(jcli.main, argv)
    assert rc == rc_j == 0 and got == want


@pytest.mark.parametrize("flags", [["--grp-attn-n", "2"]])
def test_cli_unported_options_exit(ggufs, flags):
    """The options the cli once refused as not ported (self-extend,
    --grp-attn-n above 1) now run: a greedy completion of 12 tokens on
    dense weights equals the JAX cli's with the same flags."""
    argv = ["-m", ggufs["tiny"], "-p", PROMPTS["tiny"], "-n", "12", "--temp", "0",
            "--mode", "dense", "-c", "64", "--no-display-prompt", *flags]
    rc, got, _ = _run(cli.main, argv + ["--device", "cpu"])
    rc_j, want, _ = _run(jcli.main, argv)
    assert rc == rc_j == 0 and got == want and got.strip()


def test_chat_two_turns(ggufs):
    """Two scripted turns through stdin, each rendered by the chat template
    and answered greedily; an empty line ends the session."""
    rc, out, err = _run(cli.main, ["-m", ggufs["tiny-moe"], "--device", "cpu", "--chat",
                                   "-n", "4", "--temp", "0", "-c", "512"],
                        stdin="hello there\nand again\n\n")
    assert rc == 0 and "chat" in err
    assert out.count("> ") == 3 and len(out.splitlines()) == 3


def _engines(path, f32: bool = False):
    """Both Engines; with `f32` dense f32 weights and an f32 cache (the JAX
    tools rebuild the cache from kv_dtype, so the JAX one takes a dtype)."""
    if not f32:
        return Engine(path, device="cpu", max_seq=64), JEngine(path, max_seq=64)
    return (Engine(path, device="cpu", max_seq=64, mode="dense", dtype=torch.float32,
                   kv_dtype="f32"),
            JEngine(path, max_seq=64, mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32))


@pytest.mark.parametrize("weights", ["auto", "dense-f32"])
def test_perplexity_as_jax(ggufs, weights):
    """PPL over three 32-token windows of the corpus on tiny-moe: the same
    count, the PPL within RTOL_AUTO (auto weights, bf16 cache) or RTOL_F32
    (dense f32 weights, f32 cache)."""
    te, je = _engines(ggufs["tiny-moe"], f32=weights == "dense-f32")
    got = perplexity.perplexity(te, CORPUS, n_ctx=32, max_windows=3)
    want = jppl.perplexity(je, CORPUS, n_ctx=32, max_windows=3)
    assert got[1] == want[1] == 3 * 15
    assert got[0] == pytest.approx(want[0], rel=RTOL_AUTO if weights == "auto" else RTOL_F32)


def test_perplexity_past_f64_is_inf(ggufs):
    """The tiny dense model's mean NLL passes log(f64 max): the port's PPL
    is inf with the reference's count, and so is each window's progress
    value; the JAX tool raises OverflowError on the same windows."""
    te, je = _engines(ggufs["tiny"])
    seen = []
    ppl, count = perplexity.perplexity(te, CORPUS, n_ctx=32, max_windows=2,
                                       progress=lambda i, n, p: seen.append(p))
    assert ppl == float("inf") and count == 2 * 15 and seen == [float("inf")] * 2
    with pytest.raises(OverflowError):
        jppl.perplexity(je, CORPUS, n_ctx=32, max_windows=2)


@pytest.mark.parametrize("weights", ["auto", "dense-f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_choice_scores_and_accuracy_as_jax(ggufs, shape, weights):
    """choice_logprob (sums and normalized) and multiple_choice_accuracy on
    tests/test_tools.py's task: equal to the JAX tool's, and 1.0 (the
    model's own greedy continuation wins) where the continuation's text
    tokenizes back to its ids (on tiny it is byte tokens of no UTF-8)."""
    te, je = _engines(ggufs[shape], f32=weights == "dense-f32")
    rtol = RTOL_AUTO if weights == "auto" else RTOL_F32
    ctx = te.tokenizer.tokenize("the quick brown", add_special=True)
    ending = te.tokenizer.tokenize(" fox jumps over the lazy dog", add_special=False)
    for normalize in (False, True):
        assert perplexity.choice_logprob(te, ctx, ending, normalize) == pytest.approx(
            jppl.choice_logprob(je, ctx, ending, normalize), rel=rtol)
    te.reset()
    greedy = [int(np.argmax(te.prefill(ctx)))]
    for _ in range(3):
        greedy.append(int(np.argmax(te.decode_step(greedy[-1]))))
    tasks = [{"context": "the quick brown",
              "endings": [" zxqj vvk wqx", te.tokenizer.detokenize(greedy), " lorem ipsum"],
              "label": 1}]
    acc = perplexity.multiple_choice_accuracy(te, tasks)
    assert acc == jppl.multiple_choice_accuracy(je, tasks)
    full = te.tokenizer.tokenize("the quick brown" + tasks[0]["endings"][1], add_special=True)
    if full[len(ctx):] == greedy:  # the continuation's text tokenizes back to it
        assert acc == 1.0


@pytest.mark.parametrize("shape", SHAPES)
def test_kld_as_jax(ggufs, tmp_path, shape):
    """A base recorded by each package's dense f32 engine: the same npz
    (ids, n_ctx, f16 logits within f16 rounding); the KLD of each
    package's default engine against the JAX base within RTOL_AUTO, and
    the same-top share within one token in 64."""
    td, jd = _engines(ggufs[shape], f32=True)
    perplexity.save_logits_base(td, CORPUS, tmp_path / "port.npz", n_ctx=32, max_windows=2)
    jppl.save_logits_base(jd, CORPUS, tmp_path / "jax.npz", n_ctx=32, max_windows=2)
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files) and int(a["n_ctx"]) == int(b["n_ctx"]) == 32
    assert np.array_equal(a["ids"], b["ids"]) and a["logits"].shape == b["logits"].shape
    np.testing.assert_allclose(a["logits"].astype(np.float32), b["logits"].astype(np.float32),
                               rtol=2e-3, atol=2e-3 * float(np.abs(b["logits"]).max()))
    te, je = _engines(ggufs[shape])
    got = perplexity.kld_vs_base(te, CORPUS, str(tmp_path / "jax.npz"))
    want = jppl.kld_vs_base(je, CORPUS, str(tmp_path / "jax.npz"))
    assert got["n_tokens"] == want["n_tokens"] == 64
    assert got["kld"] == pytest.approx(want["kld"], rel=RTOL_AUTO, abs=1e-6)
    assert abs(got["same_top_p"] - want["same_top_p"]) <= 1 / 64


def test_perplexity_main_prints_as_jax(ggufs, tmp_path):
    """The tool's json lines: PPL, the KLD run against a base it recorded,
    and the multiple-choice run, keyed as the JAX tool's."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(CORPUS)
    m = ggufs["tiny-moe"]
    base = ["-m", m, "-f", str(corpus), "-c", "32", "--max-windows", "2", "--json"]
    rc, out, _ = _run(perplexity.main, base + ["--device", "cpu"])
    rc_j, out_j, _ = _run(jppl.main, base)
    got, want = json.loads(out), json.loads(out_j)
    assert rc == rc_j == 0 and got.keys() == want.keys() and got["n_tokens"] == want["n_tokens"]
    assert got["ppl"] == pytest.approx(want["ppl"], rel=RTOL_AUTO)
    npz = str(tmp_path / "base.npz")
    assert _run(perplexity.main, base + ["--device", "cpu", "--mode", "dense",
                                         "--kl-divergence-base", npz])[0] == 0
    rc, out, _ = _run(perplexity.main, base + ["--device", "cpu", "--kl-divergence", npz])
    res = json.loads(out)
    assert rc == 0 and set(res) == {"kld", "same_top_p", "n_tokens"} and res["kld"] >= 0
    tasks = tmp_path / "tasks.jsonl"
    tasks.write_text(json.dumps({"context": "the quick", "endings": [" brown", " zxq"],
                                 "label": 0}) + "\n")
    mc = ["-m", m, "-f", str(tasks), "--multiple-choice", "--json"]
    rc, out, _ = _run(perplexity.main, mc + ["--device", "cpu"])
    assert rc == 0 and json.loads(out) == json.loads(_run(jppl.main, mc)[1])


@pytest.mark.parametrize("kv", ["f16", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_engine_kv_dtypes_as_jax(ggufs, shape, kv):
    """Engine(kv_dtype="f16"|"f32"): the greedy ids of generate_tokens (the
    host loop over decode_step) equal to the JAX Engine's."""
    te = Engine(ggufs[shape], device="cpu", max_seq=48, kv_dtype=kv)
    je = JEngine(ggufs[shape], max_seq=48, kv_dtype=kv)
    assert te.kv_dtype == kv and te.cache.k.dtype == {"f16": torch.float16,
                                                      "f32": torch.float32}[kv]
    ids = te.tokenizer.tokenize(PROMPTS[shape], add_special=True)
    got = list(te.generate_tokens(ids, 12, stop_on_eog=False))
    assert got == list(je.generate_tokens(ids, 12, stop_on_eog=False)) and len(got) == 12


def test_bench_rows_as_jax(ggufs):
    """The bench's rows: the JAX tool's keys for each case, over the cache
    types, in every output format; the sql schema equal."""
    kw = dict(n_prompt=[8], n_gen=[3], depths=[0, 16], reps=2, mode="auto", ctx=64,
              kv_types=["bf16", "q8_0"])
    rows = bench.run_matrix(ggufs["tiny"], device="cpu", **kw)
    ref = jbench.run_matrix(ggufs["tiny"], **kw)
    assert [r.keys() for r in rows] == [r.keys() for r in ref] and len(rows) == 4
    assert [(r["type_kv"], r["n_depth"]) for r in rows] == \
        [(r["type_kv"], r["n_depth"]) for r in ref]
    assert all(r["pp_ts"] > 0 and r["tg_ts"] > 0 for r in rows)
    sql, sql_j = io.StringIO(), io.StringIO()
    bench.emit_sql(rows, sql)
    jbench.emit_sql(rows, sql_j)
    assert sql.getvalue() == sql_j.getvalue()
    for fmt in ("md", "csv", "json", "jsonl", "sql"):
        rc, out, _ = _run(bench.main, ["-m", ggufs["tiny"], "--device", "cpu", "-p", "8",
                                       "-n", "2", "-r", "1", "-c", "64", "-o", fmt])
        assert rc == 0 and out.strip()
    rc, out, _ = _run(bench.main, ["-m", ggufs["tiny"], "--device", "cpu", "-p", "8", "-n", "2",
                                   "-r", "1", "-c", "64", "-ctk", "f16,f32", "-o", "jsonl"])
    assert [json.loads(line)["type_kv"] for line in out.splitlines()] == ["f16", "f32"]


def test_bench_profile_writes_a_trace(ggufs, tmp_path):
    rc, _, err = _run(bench.main, ["-m", ggufs["tiny"], "--device", "cpu", "-p", "8", "-n", "2",
                                   "-r", "1", "-c", "64", "--profile", str(tmp_path / "prof")])
    assert rc == 0 and (tmp_path / "prof" / "bench_trace.json").stat().st_size > 0


@pytest.mark.parametrize("flags", [["--ids"], [], ["--ids", "--no-bos"],
                                   ["--ids", "--no-parse-special"]])
def test_tokenize_as_jax(ggufs, flags):
    argv = ["-m", ggufs["tiny"], "-p", "hello world <s> the quick brown fox", "--show-count",
            *flags]
    assert _run(tokenize.main, argv) == _run(jtokenize.main, argv)


def test_compare_bench_as_jax(tmp_path):
    old = [{"model": "m.gguf", "mode": "auto", "type_kv": "bf16", "n_prompt": 512, "n_gen": 0,
            "n_depth": 0, "pp_ts": 1000.0, "pp_stddev": 10.0},
           {"model": "m.gguf", "mode": "auto", "type_kv": "bf16", "n_prompt": 0, "n_gen": 128,
            "n_depth": 0, "tg_ts": 100.0, "tg_stddev": 1.0}]
    new = [dict(old[0], pp_ts=1100.0), dict(old[1], tg_ts=99.5)]
    (tmp_path / "old.json").write_text(json.dumps(old))
    (tmp_path / "new.json").write_text(json.dumps(new))
    argv = [str(tmp_path / "old.json"), str(tmp_path / "new.json")]
    assert _run(compare_bench.main, argv) == _run(jcompare.main, argv)


@pytest.mark.parametrize("ftype", list(PRESETS))
def test_dense_weights_equal_jax(tmp_path, ftype):
    """Weight mode "dense": every linear (and tiny-moe's expert stacks) is
    the JAX package's dense_from_info of the same tensor (its host f32
    codec, rounded once to bf16), bit for bit; "auto" keeps them packed."""
    from tpullm.gguf.reader import GGUFReader as JReader
    from tpullm.models.weights import dense_from_info

    from tpullm_torch.gguf.reader import GGUFReader
    from tpullm_torch.models.llama import build_params
    from tpullm_torch.models.registry import load_hparams
    from tpullm_torch.models.weights import DenseLinear, QuantLinear

    shape = "tiny-moe" if ftype == "MXFP4_MOE" else "tiny"
    path = make_synthetic_llama_gguf(tmp_path / "m.gguf", shape=shape, seed=0, ftype=ftype)
    r, jr = GGUFReader(path), JReader(path)
    hp = load_hparams(r)
    dense = build_params(r, hp, torch.device("cpu"), torch.bfloat16, mode="dense")
    auto = build_params(r, hp, torch.device("cpu"), torch.bfloat16)
    names = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
             "w_gate": "ffn_gate", "w_up": "ffn_up", "w_down": "ffn_down"}
    checked = 0
    for i, (layer, layer_auto) in enumerate(zip(dense["layers"], auto["layers"])):
        for key, name in names.items():
            if layer.get(key) is None:
                continue
            want = np.asarray(dense_from_info(jr.tensors[f"blk.{i}.{name}.weight"]).w
                              .astype(jnp.float32))
            assert isinstance(layer[key], DenseLinear) and layer[key].w.dtype == torch.bfloat16
            assert np.array_equal(layer[key].w.float().numpy(), want), (i, key)
            assert isinstance(layer_auto[key], QuantLinear)
            checked += 1
        for key in ("w_gate_exps", "w_up_exps", "w_down_exps"):
            if key in layer:
                info = jr.tensors[f"blk.{i}.ffn_{key[2:].replace('_exps', '')}_exps.weight"]
                want = info.to_numpy().transpose(0, 2, 1)
                got = layer[key]
                assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
                assert np.array_equal(got.float().numpy(),
                                      torch.from_numpy(np.ascontiguousarray(want))
                                      .to(torch.bfloat16).float().numpy()), (i, key)
                checked += 1
    want = np.asarray(dense_from_info(jr.tensors["output.weight"]).w.astype(jnp.float32))
    assert np.array_equal(dense["output"].w.float().numpy(), want)
    assert checked >= 2 * 4


def test_dense_mode_engine_as_jax(ggufs):
    """Engine(mode="dense") greedy ids equal to the JAX Engine's in its
    dense mode (the tiny-moe prompt; bf16 weights and cache)."""
    te = Engine(ggufs["tiny-moe"], device="cpu", max_seq=48, mode="dense")
    je = JEngine(ggufs["tiny-moe"], max_seq=48, mode="dense")
    ids = te.tokenizer.tokenize(PROMPTS["tiny-moe"], add_special=True)
    got = list(te.generate_tokens(ids, 12, stop_on_eog=False))
    assert got == list(je.generate_tokens(ids, 12, stop_on_eog=False))
