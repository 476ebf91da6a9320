"""Port parity of the serving stack: tpullm_torch.server (the Scheduler over
the port's BatchEngine, and the OpenAI-compatible server on the standard
library's http.server) against the JAX package's (its Scheduler and its
aiohttp server), both on the CPU on the same tiny synthetic GGUFs.

The scheduler cases of tests/test_server.py that this slice covers run on
the port; the HTTP cases send the same requests to both servers (the port's
through http.client on port 0) and compare the JSON bodies, apart from
`id`, `created` and the timings, and the joined SSE text. Floats in the
bodies (embeddings, logprobs) come from two implementations' sums and are
held to NMSE 1e-3 (embeddings) or a relative 2e-2 (logprobs). The
requests compared across the packages are greedy: the tiny MoE's logits
are ≈ 3 and differ between the packages by ≈ 0.02 (bf16 rounding in
another order), enough to move a temp-0.8 draw across a boundary of the
sampler chain within ten tokens; seeded requests are held to their own
rerun. The tiny dense model's ids are one token over and over (its head
favours one row), so the text comparisons run on the tiny MoE, whose
greedy outputs vary, and on grammar-forced outputs.

Every queue read, thread join and HTTP call has a timeout, and every
server and scheduler is stopped in a `finally`."""

import http.client
import json
import threading

import numpy as np
import pytest

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.sampling import SamplerParams as JSamplerParams
from tpullm.server.scheduler import GenRequest as JGenRequest
from tpullm.server.scheduler import Scheduler as JScheduler

from tpullm_torch.gguf.constants import GGUFValueType
from tpullm_torch.models.synth import make_synthetic_llama_gguf, synthetic_writer
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.sampling import SamplerParams
from tpullm_torch.server.api import Server, serve
from tpullm_torch.server.router import make_router_app
from tpullm_torch.server.scheduler import GenRequest, Scheduler

TIMEOUT = 120  # seconds: any one queue read, join or HTTP call
VOLATILE = ("id", "created", "timings")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("server")
    fim = synthetic_writer(d / "fim.gguf", shape="tiny", seed=0)
    for key, tok in (("pre", 3), ("suf", 4), ("mid", 5)):
        fim.add_kv(f"tokenizer.ggml.fim_{key}_token_id", tok, GGUFValueType.UINT32)
    fim.write()
    return {"tiny": make_synthetic_llama_gguf(d / "tiny.gguf", shape="tiny", seed=0),
            "tiny-moe": make_synthetic_llama_gguf(d / "tiny-moe.gguf", shape="tiny-moe",
                                                  seed=0),
            "fim": str(d / "fim.gguf")}


def _engine(path, **kw):
    kw = {"n_slots": 3, "max_seq": 128, "mode": "dense", "prefill_chunk": 32, **kw}
    return BatchEngine(path, device="cpu", **kw)


def _jax_engine(path, **kw):
    kw = {"n_slots": 3, "max_seq": 128, "mode": "dense", "prefill_chunk": 32, **kw}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")  # the load the port mirrors
        return JBatchEngine(path, **kw)


@pytest.fixture(scope="module")
def engine(paths):
    return _engine(paths["tiny"])


@pytest.fixture(scope="module")
def engines(paths):
    """The port's and the JAX package's engines on tiny-moe, made once."""
    return _engine(paths["tiny-moe"]), _jax_engine(paths["tiny-moe"])


@pytest.fixture(autouse=True)
def _free_slots(request):
    """Every module engine starts a test with its slots free."""
    for name in ("engine", "engines"):
        if name in request.fixturenames:
            got = request.getfixturevalue(name)
            for eng in got if isinstance(got, tuple) else (got,):
                for s in range(eng.n_slots):
                    eng.free_slot(s)
    yield


def _drain(req, timeout=TIMEOUT):
    """(token ids, finish reason, stats) of a request; each event waited
    for at most `timeout` s."""
    toks = []
    while True:
        ev = req.out.get(timeout=timeout)
        if ev[0] == "token":
            toks.append(ev[1])
        else:
            return toks, ev[1], ev[2]


class _Running:
    """A started Scheduler, stopped on exit."""

    def __init__(self, sched):
        self.sched = sched

    def __enter__(self):
        self.sched.start()
        return self.sched

    def __exit__(self, *exc):
        self.sched.stop()
        assert not self.sched._thread.is_alive()


def _greedy(sched, ids, n, cls=GenRequest, params=SamplerParams):
    return _drain(sched.submit(cls(prompt_ids=ids, max_tokens=n, sampling=params(temp=0.0))))[0]


# -- the scheduler ---------------------------------------------------------------

def test_scheduler_single_request(engine):
    with _Running(Scheduler(engine)) as sched:
        ids = engine.tokenizer.tokenize("the quick brown", add_special=True)
        toks, reason, stats = _drain(sched.submit(
            GenRequest(prompt_ids=ids, max_tokens=8, sampling=SamplerParams(temp=0.0))))
    assert reason in ("stop", "length")
    assert stats["prompt_n"] == len(ids) and stats["predicted_n"] == len(toks)
    assert stats["ttft_ms"] >= 0


def _submit_then_run(sched, reqs):
    """Queue `reqs` before the scheduler starts, so its rounds and steps
    (which rows share a forward) do not depend on thread timing; then their
    (ids, finish reason)."""
    for r in reqs:
        sched.submit(r)
    with _Running(sched):
        return [_drain(r)[:2] for r in reqs]


def test_scheduler_requests_match_jax(engines):
    """Five greedy requests on three slots (two wait for a slot): each
    request's ids and finish reason equal to the JAX scheduler's for the
    same requests; and seeded requests (temp 0.8) give the same ids when
    sent again."""
    te, je = engines
    prompts = ["hello world", "the quick brown fox", "hello world", "the lazy dog", "hi"]
    runs = [_submit_then_run(sched_cls(eng), [
        cls(prompt_ids=eng.tokenizer.tokenize(p, add_special=True), max_tokens=10,
            sampling=params(temp=0.0)) for p in prompts])
        for eng, cls, params, sched_cls in ((te, GenRequest, SamplerParams, Scheduler),
                                            (je, JGenRequest, JSamplerParams, JScheduler))]
    assert runs[0] == runs[1]
    assert len({tuple(r[0]) for r in runs[0]}) > 1  # the tiny MoE's outputs vary
    sampled = [_submit_then_run(Scheduler(te), [
        GenRequest(prompt_ids=te.tokenizer.tokenize(p, add_special=True), max_tokens=10,
                   sampling=SamplerParams(temp=0.8, seed=i)) for i, p in enumerate(prompts)])
        for _ in range(2)]
    assert sampled[0] == sampled[1]


def test_scheduler_grammar_matches_jax(engines):
    """A json-schema grammar: the output is a valid prefix of the grammar's
    language, and the ids are the JAX scheduler's."""
    from tpullm_torch.grammar import GrammarMatcher, json_schema_to_gbnf, parse_gbnf

    gbnf = json_schema_to_gbnf({"type": "object", "properties": {"n": {"type": "integer"}},
                                "required": ["n"], "additionalProperties": False})
    te, je = engines
    outs = []
    for eng, cls, params, sched_cls in ((te, GenRequest, SamplerParams, Scheduler),
                                        (je, JGenRequest, JSamplerParams, JScheduler)):
        with _Running(sched_cls(eng)) as sched:
            ids = eng.tokenizer.tokenize("the quick", add_special=True)
            outs.append(_drain(sched.submit(cls(prompt_ids=ids, max_tokens=24,
                                                sampling=params(temp=0.0), grammar=gbnf))))
    (toks, reason, _), (ref, ref_reason, _) = outs
    assert toks == ref and reason == ref_reason
    text = te.tokenizer.detokenize(toks)
    assert GrammarMatcher(parse_gbnf(gbnf)).accept_text(text), text
    if reason == "stop":
        assert isinstance(json.loads(text)["n"], int)


def test_prompt_prefix_reuse(engine):
    """A second request that extends the first reuses the slot's cache
    prefix, and gives the ids of a fresh engine."""
    tok = engine.tokenizer
    with _Running(Scheduler(engine)) as sched:
        ids1 = tok.tokenize("the quick brown fox jumps over the lazy dog", add_special=True)
        toks1 = _greedy(sched, ids1, 4)
        assert sched.n_reused_tokens == 0
        ids2 = ids1 + toks1 + tok.tokenize(" and then", add_special=False)
        toks2 = _greedy(sched, ids2, 4)
        assert sched.n_reused_tokens > 0
    fresh = _engine(engine.reader.path, n_slots=1)
    with _Running(Scheduler(fresh)) as sched:
        assert _greedy(sched, ids2, 4) == toks2


def test_context_shift_long_generation(paths):
    """Generation past the context (max_seq 48) goes on through context
    shifts."""
    eng = _engine(paths["tiny"], n_slots=1, max_seq=48, prefill_chunk=16)
    with _Running(Scheduler(eng)) as sched:
        ids = eng.tokenizer.tokenize("the quick brown", add_special=True)
        toks, reason, _ = _drain(sched.submit(GenRequest(
            prompt_ids=ids, max_tokens=100, sampling=SamplerParams(temp=0.0))))
        assert len(toks) == 100 and reason == "length" and sched.n_context_shifts >= 1


def test_scheduler_cache_reuse_punches_holes(engine):
    """A second prompt that drops one middle token reuses the shifted
    suffix chunk: more reused tokens than the common prefix."""
    sched = Scheduler(engine, cache_reuse=4)
    assert sched.cache_reuse == 4
    tok = engine.tokenizer.tokenize
    with _Running(sched):
        base = tok("the quick brown fox jumps over the lazy dog again and again",
                   add_special=True)
        _greedy(sched, base, 2)
        before = sched.n_reused_tokens
        drop = len(base) // 2
        assert len(_greedy(sched, base[:drop] + base[drop + 1:], 2)) >= 1
        assert sched.n_reused_tokens - before > drop


def test_scheduler_lazy_grammar_stays_inactive(engine):
    """A lazy grammar whose trigger never fires leaves generation free."""
    with _Running(Scheduler(engine)) as sched:
        ids = engine.tokenizer.tokenize("the quick brown", add_special=True)
        toks, reason, _ = _drain(sched.submit(GenRequest(
            prompt_ids=ids, max_tokens=8, sampling=SamplerParams(temp=0.0),
            grammar='root ::= "\\x00unreachable\\x00"',
            grammar_triggers=[{"type": "word", "value": "\\x00never\\x00"}])))
    assert reason == "length" and len(toks) == 8


def test_thread_safety_stress(engine):
    """Submits from eight threads and two embedding calls at once; a rerun
    of two prompts gives the same ids; the graphs' capture (precompile) and
    the embeddings run on the scheduler's thread."""
    errors, results = [], {}
    seen = set()
    orig = engine.embed_tokens

    def embed_tokens(*a, **k):
        seen.add(threading.current_thread().name)
        return orig(*a, **k)

    engine.embed_tokens = embed_tokens
    try:
        with _Running(Scheduler(engine)) as sched:
            sched.precompile(background=False)

            def worker(i):
                try:
                    ids = engine.tokenizer.tokenize(f"the quick brown number {i}",
                                                    add_special=True)
                    results[i] = _greedy(sched, ids, 4)
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            def embed_worker():
                try:
                    v = sched.embed(engine.tokenizer.tokenize("embedding probe",
                                                              add_special=True))
                    assert v.shape == (engine.hp.n_embd,)
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
            threads += [threading.Thread(target=embed_worker) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors
            assert len(results) == 8
            for i in (0, 3):
                ids = engine.tokenizer.tokenize(f"the quick brown number {i}", add_special=True)
                assert _greedy(sched, ids, 4) == results[i]
    finally:
        engine.embed_tokens = orig
    assert seen == {"tpullm-torch-sched"}


def test_scheduler_survives_a_request_it_cannot_admit(engine):
    """A grammar that does not parse fails its own request ("error") and
    the scheduler goes on serving the next one."""
    ids = engine.tokenizer.tokenize("the quick", add_special=True)
    with _Running(Scheduler(engine)) as sched:
        bad = _drain(sched.submit(GenRequest(prompt_ids=ids, max_tokens=4,
                                             grammar="root ::= (")))
        assert bad[0] == [] and bad[1] == "error" and "GBNFError" in bad[2]["error"]
        assert sched._thread.is_alive() and len(_greedy(sched, ids, 4)) == 4


# -- HTTP --------------------------------------------------------------------------

def _port_http(app, requests, headers=None):
    """(status, content type, body text) of each (method, path, body) sent
    to `app` served on 127.0.0.1:0, in order."""
    httpd = serve(app, "127.0.0.1", 0)
    out = []
    try:
        for method, path, body in requests:
            c = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                           timeout=TIMEOUT)
            try:
                c.request(method, path, None if body is None else json.dumps(body),
                          {"Content-Type": "application/json", **(headers or {})})
                r = c.getresponse()
                out.append((r.status, r.getheader("Content-Type"), r.read().decode()))
            finally:
                c.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
    return out


def _jax_http(sched, requests, headers=None, **server_kw):
    """The same through the JAX package's aiohttp server (its test client)."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from tpullm.server.api import Server as JServer

    async def run():
        client = TestClient(TestServer(JServer(sched, model_name="tiny", **server_kw).app))
        await client.start_server()
        out = []
        try:
            for method, path, body in requests:
                if method == "GET":
                    r = await client.get(path, headers=headers)
                else:
                    r = await client.post(path, json=body, headers=headers)
                out.append((r.status, r.headers.get("Content-Type"), await r.text()))
        finally:
            await client.close()
        return out

    return asyncio.run(asyncio.wait_for(run(), timeout=10 * TIMEOUT))


def _strip(obj):
    """The JSON value without VOLATILE keys (at any depth)."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _assert_json_equal(got, ref, rel=0.0, path="$"):
    """Equal JSON values; floats within `rel` of the reference's magnitude."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (path, got, ref)
        for k in ref:
            _assert_json_equal(got[k], ref[k], rel, f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), (path, got, ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_json_equal(g, r, rel, f"{path}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert abs(got - ref) <= rel * max(1.0, abs(ref)), (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def _sse(text):
    """The data payloads of an SSE body."""
    return [ln[6:] for ln in text.split("\n") if ln.startswith("data: ")]


def _sse_text(text, chat):
    key = "delta" if chat else None
    parts = []
    for p in _sse(text)[:-1]:
        ch = json.loads(p)["choices"][0]
        parts.append(ch[key].get("content") or "" if chat else ch["text"])
    return "".join(parts)


CHAT = [{"role": "user", "content": "hello world"}]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather",
    "parameters": {"type": "object", "properties": {"city": {"enum": ["Paris", "Tokyo"]}},
                   "required": ["city"]}}}]
# (method, path, body): every endpoint of the slice, greedy generation
EXACT = [
    ("GET", "/health", None),
    ("GET", "/v1/health", None),
    ("GET", "/props", None),
    ("POST", "/tokenize", {"content": "hello world", "add_special": True}),
    ("POST", "/detokenize", {"tokens": [1, 300, 301]}),
    ("POST", "/apply-template", {"messages": CHAT}),
    ("POST", "/v1/completions", {"prompt": "hello world", "max_tokens": 8, "temperature": 0}),
    ("POST", "/completion", {"prompt": "the quick", "n_predict": 6, "temperature": 0}),
    ("POST", "/completions", {"prompt": "the lazy dog", "max_tokens": 6, "temperature": 0}),
    ("POST", "/v1/completions", {"prompt": "hello world", "max_tokens": 4, "temperature": 0,
                                 "stop": ["zzz"], "grammar": 'root ::= "abc" [a-z]*'}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 8, "temperature": 0}),
    ("POST", "/chat/completions", {"messages": CHAT, "max_tokens": 40, "temperature": 0,
                                   "grammar": 'root ::= "<think>why</think>because"'}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 120, "temperature": 0,
                                      "tools": TOOLS, "tool_choice": "required"}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 8, "temperature": 0,
                                      "response_format": {"type": "json_object"}}),
    ("POST", "/infill", {"input_prefix": "x"}),
    ("GET", "/slots", None),
]
STREAMED = [
    ("POST", "/v1/completions", {"prompt": "hello world", "max_tokens": 8, "temperature": 0,
                                 "stream": True}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 8, "temperature": 0,
                                      "stream": True}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 120, "temperature": 0,
                                      "tools": TOOLS, "tool_choice": "required",
                                      "stream": True}),
]


def _both(engines, requests, **kw):
    """The requests through the port's server and the JAX server, each on
    a fresh scheduler over its module engine (slots freed first)."""
    te, je = engines
    out = []
    for eng, sched_cls, send in ((te, Scheduler, lambda s: _port_http(
            Server(s, model_name="tiny", **kw).app, requests)),
                                 (je, JScheduler, lambda s: _jax_http(s, requests, **kw))):
        for slot in range(eng.n_slots):
            eng.free_slot(slot)
        sched = sched_cls(eng)
        sched.start()
        try:
            out.append(send(sched))
        finally:
            sched.stop()
    return out


def test_http_endpoints_match_jax(engines):
    """Each endpoint of the slice: the status, the content type and the
    JSON body of the JAX server (apart from id, created and timings); the
    tool call forced by tool_choice=required and the reasoning extracted
    from a grammar-forced <think> block among them."""
    got, ref = _both(engines, EXACT)
    for (method, path, body), g, r in zip(EXACT, got, ref):
        assert g[0] == r[0], (path, body, g, r)
        assert g[1].split(";")[0] == r[1].split(";")[0], (path, g[1], r[1])
        _assert_json_equal(_strip(json.loads(g[2])), _strip(json.loads(r[2])))
    by_body = {json.dumps(b): json.loads(g[2]) for (_, _, b), g in zip(EXACT, got)}
    think = by_body[json.dumps(EXACT[11][2])]["choices"][0]["message"]
    assert think == {"role": "assistant", "content": "because", "reasoning_content": "why"}
    call = by_body[json.dumps(EXACT[12][2])]["choices"][0]
    assert call["finish_reason"] == "tool_calls"
    assert json.loads(call["message"]["tool_calls"][0]["function"]["arguments"])["city"] in \
        ("Paris", "Tokyo")


def test_http_text_endpoints_match_jax(engines):
    """/metrics (the same counter lines after the same request) and the
    model list (the same body but for the start time)."""
    reqs = [("POST", "/v1/completions", {"prompt": "hi", "max_tokens": 3, "temperature": 0}),
            ("GET", "/metrics", None), ("GET", "/v1/models", None), ("GET", "/models", None)]
    got, ref = _both(engines, reqs)
    assert got[1][2] == ref[1][2] and got[1][1].startswith("text/plain")
    for g, r in zip(got[2:], ref[2:]):
        _assert_json_equal(_strip(json.loads(g[2])), _strip(json.loads(r[2])))


def test_http_streams_match_jax(engines):
    """SSE: the same chunks (the object, the choices and their deltas or
    text, the final finish reason), ending in [DONE], joined to the same
    text; the tool call's argument deltas among them."""
    got, ref = _both(engines, STREAMED)
    for (_, path, body), g, r in zip(STREAMED, got, ref):
        assert g[0] == r[0] == 200 and g[1].startswith("text/event-stream")
        gs, rs = _sse(g[2]), _sse(r[2])
        assert gs[-1] == rs[-1] == "[DONE]"
        assert [_strip(json.loads(x)) for x in gs[:-1]] == \
            [_strip(json.loads(x)) for x in rs[:-1]]
        chat = path.endswith("chat/completions")
        assert _sse_text(g[2], chat) == _sse_text(r[2], chat)


def test_http_logprobs_and_embeddings_match_jax(engines):
    """logprobs in /v1/completions (the same tokens, log probabilities
    within 2e-2 relative) and the three embedding routes (vectors within
    NMSE 1e-3)."""
    reqs = [("POST", "/v1/completions", {"prompt": "hello world", "max_tokens": 3,
                                         "temperature": 0, "logprobs": 3})]
    reqs += [("POST", p, {"input": ["hello world", "the quick brown fox"]})
             for p in ("/embedding", "/embeddings", "/v1/embeddings")]
    got, ref = _both(engines, reqs)
    g, r = json.loads(got[0][2]), json.loads(ref[0][2])
    _assert_json_equal(_strip(g), _strip(r), rel=2e-2)
    for gg, rr in zip(got[1:], ref[1:]):
        g, r = json.loads(gg[2]), json.loads(rr[2])
        for dg, dr in zip(g["data"], r["data"]):
            a, b = np.asarray(dg.pop("embedding")), np.asarray(dr.pop("embedding"))
            assert float(np.mean((a - b) ** 2) / np.mean(b * b)) <= 1e-3
        assert g == r


def test_http_infill_matches_jax(paths):
    """/infill on a model with FIM tokens (<fim_pre>prefix<fim_suf>suffix
    <fim_mid>): the JAX server's body."""
    te, je = _engine(paths["fim"], n_slots=2), _jax_engine(paths["fim"], n_slots=2)
    req = [("POST", "/infill", {"input_prefix": "def add(a, b):\n    ",
                                "input_suffix": "\n    return out", "max_tokens": 4,
                                "temperature": 0})]
    got, ref = _both((te, je), req)
    assert got[0][0] == ref[0][0] == 200
    _assert_json_equal(_strip(json.loads(got[0][2])), _strip(json.loads(ref[0][2])))


def test_http_slot_actions(engine, tmp_path):
    """POST /slots/{id}?action=save|restore|erase, the JAX server's bodies;
    the restored slot continues as the saved one did."""
    reqs = [("POST", "/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 2,
                                         "temperature": 0}),
            ("POST", "/slots/0?action=save", {"filename": "s0.npz"}),
            ("POST", "/slots/1?action=restore", {"filename": "s0.npz"}),
            ("POST", "/slots/1?action=erase", {}),
            ("POST", "/slots/7?action=save", {}),
            ("POST", "/slots/0?action=nope", {})]
    with _Running(Scheduler(engine)) as sched:
        out = _port_http(Server(sched, slot_save_path=str(tmp_path)).app, reqs)
        n = int(engine.n_past[0])
    bodies = [json.loads(o[2]) for o in out]
    assert [o[0] for o in out] == [200, 200, 200, 200, 400, 400]
    assert bodies[1] == {"id_slot": 0, "n_saved": n} and (tmp_path / "s0.npz").exists()
    assert bodies[2] == {"id_slot": 1, "n_restored": n}
    assert bodies[3] == {"id_slot": 1, "n_erased": 1} and engine.n_past[1] == 0
    assert bodies[4] == {"error": {"message": "invalid slot"}}
    no_path = _port_http(Server(Scheduler(engine)).app, reqs[1:2])
    assert no_path[0][0] == 400 and "slot-save-path" in no_path[0][2]


# the deferred routes and the ROADMAP.md items their 501 names
DEFERRED = [("POST", "/v1/messages", "1.3.1"), ("POST", "/v1/messages/count_tokens", "1.3.1"),
            ("POST", "/v1/responses", "1.3.2"), ("POST", "/rerank", "1.3.3"),
            ("POST", "/reranking", "1.3.3"), ("POST", "/v1/rerank", "1.3.3"),
            ("POST", "/v1/reranking", "1.3.3"), ("GET", "/api/tags", "1.3.4"),
            ("POST", "/api/show", "1.3.4"), ("GET", "/", "1.3.5"), ("GET", "/index.html", "1.3.5"),
            ("GET", "/manifest.webmanifest", "1.3.5"), ("GET", "/sw.js", "1.3.5"),
            ("GET", "/icon.svg", "1.3.5")]


def test_deferred_routes_answer_501(engine):
    """Each route the port defers: a 501 whose JSON names its ROADMAP.md
    item; image content in a chat too; an unknown route 404, a known
    route with another method 405, a body that is not JSON 400."""
    image = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "what is this"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}]}]}
    reqs = [(m, p, {} if m == "POST" else None) for m, p, _ in DEFERRED]
    reqs += [("POST", "/v1/chat/completions", image), ("GET", "/nope", None),
             ("GET", "/v1/completions", None)]
    with _Running(Scheduler(engine)) as sched:
        app = Server(sched).app
        out = _port_http(app, reqs)
        httpd = serve(app, "127.0.0.1", 0)
        try:
            c = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=TIMEOUT)
            c.request("POST", "/tokenize", "{not json", {"Content-Type": "application/json"})
            r = c.getresponse()
            bad = (r.status, json.loads(r.read()))
            c.close()
        finally:
            httpd.shutdown()
            httpd.server_close()
    for (_, path, item), (status, _, text) in zip(DEFERRED + [(None, "chat", "1.3.7")], out):
        err = json.loads(text)["error"]
        assert status == 501 and err["code"] == 501, path
        assert f"(ROADMAP.md {item})" in err["message"] and "not ported yet" in err["message"]
    assert out[-2][:1] == (404,) and out[-1][:1] == (405,)
    assert bad[0] == 400 and bad[1]["error"]["type"] == "invalid_request_error"


def test_api_key_auth_matches_jax(engines):
    """--api-key: public endpoints open, the rest 401 without the key (the
    JAX server's error body), with Bearer or X-Api-Key 200."""
    body = {"prompt": "hi", "max_tokens": 2, "temperature": 0}
    cases = [("GET", "/health", None, {}), ("GET", "/v1/models", None, {}),
             ("POST", "/v1/completions", body, {}),
             ("POST", "/v1/completions", body, {"Authorization": "Bearer sk-wrong"}),
             ("POST", "/v1/completions", body, {"Authorization": "Bearer sk-test"}),
             ("POST", "/v1/completions", body, {"X-Api-Key": "sk-test"}),
             ("GET", "/metrics", None, {"Authorization": "Bearer sk-test"})]
    te, je = engines
    port, jax = [], []
    with _Running(Scheduler(te)) as sched:
        app = Server(sched, api_keys=["sk-test"]).app
        for m, p, b, h in cases:
            port += _port_http(app, [(m, p, b)], headers=h)
    jsched = JScheduler(je)
    jsched.start()
    try:
        for m, p, b, h in cases:
            jax += _jax_http(jsched, [(m, p, b)], headers=h, api_keys=["sk-test"])
    finally:
        jsched.stop()
    assert [o[0] for o in port] == [o[0] for o in jax] == [200, 200, 401, 401, 200, 200, 200]
    assert json.loads(port[2][2]) == json.loads(jax[2][2])


def test_router_loads_and_evicts(paths):
    """Two models behind the router (max_loaded 1): lazily loaded by the
    body's "model", the least recently used evicted (its scheduler stopped,
    its graphs dropped), explicit load and unload, 404 for an unknown one."""
    router = make_router_app({"alpha": paths["tiny"], "beta": paths["tiny-moe"]}, max_loaded=1,
                             device="cpu", n_slots=1, max_seq=64, mode="dense",
                             prefill_chunk=32)
    body = {"prompt": "the quick", "max_tokens": 2, "temperature": 0}
    try:
        out = _port_http(router.app, [
            ("GET", "/v1/models", None),
            ("POST", "/v1/completions", {**body, "model": "alpha"}),
            ("POST", "/v1/completions", {**body, "model": "beta"}),
            ("GET", "/models", None),
            ("POST", "/models/alpha/load", {}),
            ("POST", "/models/alpha/unload", {}),
            ("POST", "/models/nope/load", {}),
            ("POST", "/v1/rerank", {"model": "alpha"})])
        first = json.loads(out[0][2])["data"]
        assert {m["id"] for m in first} == {"alpha", "beta"}
        assert not any(m["meta"]["loaded"] for m in first)
        assert out[1][0] == out[2][0] == 200
        loaded = {m["id"]: m["meta"]["loaded"] for m in json.loads(out[3][2])["data"]}
        assert loaded == {"alpha": False, "beta": True}
        assert json.loads(out[4][2])["loaded"] is True
        assert json.loads(out[5][2])["loaded"] is False
        assert out[6][0] == 404 and out[7][0] == 501
        assert not router.entries["alpha"].loaded and not router.entries["beta"].loaded
    finally:
        router.shutdown()


def test_server_main_refuses_flags_not_ported(capsys):
    from tpullm_torch.server.__main__ import main

    for flag in (["--tp", "2"], ["--mmproj", "x.gguf"]):
        with pytest.raises(SystemExit):
            main(["-m", "x.gguf", *flag])
        assert "not ported yet (ROADMAP.md 1.3." in capsys.readouterr().err


@pytest.mark.parametrize("argv,want", [
    (["--spec-type", "ngram_mod", "--draft-max", "5"],
     dict(spec_type="ngram_mod", draft_model_path=None, n_draft=5)),
    (["--draft-model", "draft.gguf"], dict(spec_type=None, draft_model_path="draft.gguf",
                                           n_draft=8)),
    ([], dict(spec_type=None, draft_model_path=None, n_draft=8))],
    ids=["spec-type", "draft-model", "none"])
def test_server_main_speculation_flags_reach_make_app(monkeypatch, argv, want):
    """--spec-type (the JAX server's choices), --draft-model and
    --draft-max (default 8) parse and reach make_app; an unknown strategy
    is refused by the parser."""
    from tpullm_torch.server import __main__ as srv_main
    from tpullm_torch.server import api

    seen = {}

    class Reached(Exception):
        pass

    def fake_make_app(model, **kw):
        seen.update(kw, model=model)
        raise Reached

    monkeypatch.setattr(api, "make_app", fake_make_app)
    with pytest.raises(Reached):
        srv_main.main(["-m", "x.gguf", "--device", "cpu", *argv])
    assert seen["model"] == "x.gguf" and seen["device"] == "cpu"
    assert {k: seen[k] for k in want} == want
    with pytest.raises(SystemExit):
        srv_main.main(["-m", "x.gguf", "--spec-type", "medusa"])
