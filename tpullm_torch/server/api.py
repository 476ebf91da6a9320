"""OpenAI-compatible HTTP server over the continuous-batching scheduler (the
JAX package's server/api.py), on the standard library: `http.server`'s
ThreadingHTTPServer, server-sent events over chunked transfer.

The routes, the request parsing, the JSON bodies, the SSE chunks, the
error JSON and the API-key rule are the JAX server's. A handler thread
parses the request, submits it to the Scheduler and reads the request's
event queue; it never touches a CUDA tensor (the scheduler's thread runs
every call into the engine).

Answered with a 501 whose JSON names the ROADMAP.md item: the Anthropic
messages routes, the responses API, rerank, the Ollama routes, the WebUI
and image or audio content.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterator
from urllib.parse import parse_qsl, urlsplit

from ..chat import (StreamingToolCallParser, apply_chat_template, extract_reasoning,
                    parse_tool_calls, tool_call_grammar)
from ..grammar import json_schema_to_gbnf
from ..runtime.sampling import SamplerParams
from .scheduler import GenRequest, Scheduler

EVENT_TIMEOUT_S = 600.0  # longest wait for one event of a request


def _sampling_from_body(body: dict) -> SamplerParams:
    bias = body.get("logit_bias") or {}
    if isinstance(bias, list):  # llama.cpp style [[id, bias], ...]
        bias = {int(t): float(b) for t, b in bias}
    else:
        bias = {int(t): float(b) for t, b in bias.items()}
    return SamplerParams(
        temp=float(body.get("temperature", 0.8)),
        top_k=int(body.get("top_k", 40)),
        top_p=float(body.get("top_p", 0.95)),
        min_p=float(body.get("min_p", 0.05)),
        typical_p=float(body.get("typical_p", 1.0)),
        seed=int(body.get("seed", 0xFFFFFFFF)),
        penalty_last_n=int(body.get("repeat_last_n", 64)),
        penalty_repeat=float(body.get("repeat_penalty", 1.0)),
        penalty_freq=float(body.get("frequency_penalty", 0.0)),
        penalty_present=float(body.get("presence_penalty", 0.0)),
        dry_multiplier=float(body.get("dry_multiplier", 0.0)),
        dry_base=float(body.get("dry_base", 1.75)),
        dry_allowed_length=int(body.get("dry_allowed_length", 2)),
        dry_penalty_last_n=int(body.get("dry_penalty_last_n", -1)),
        xtc_probability=float(body.get("xtc_probability", 0.0)),
        xtc_threshold=float(body.get("xtc_threshold", 0.1)),
        top_n_sigma=float(body.get("top_n_sigma", 0.0)),
        dynatemp_range=float(body.get("dynatemp_range", 0.0)),
        dynatemp_exponent=float(body.get("dynatemp_exponent", 1.0)),
        mirostat=int(body.get("mirostat", 0)),
        mirostat_tau=float(body.get("mirostat_tau", 5.0)),
        mirostat_eta=float(body.get("mirostat_eta", 0.1)),
        logit_bias=bias,
    )


def _grammar_from_body(body: dict) -> str | None:
    """grammar / json_schema / response_format → GBNF text."""
    if body.get("grammar"):
        return str(body["grammar"])
    schema = body.get("json_schema")
    rf = body.get("response_format") or {}
    if not schema and isinstance(rf, dict):
        if rf.get("type") == "json_schema":
            schema = (rf.get("json_schema") or {}).get("schema", {})
        elif rf.get("type") == "json_object":
            schema = rf.get("schema", {})
    if schema is not None:
        return json_schema_to_gbnf(schema)
    return None


def _grammar_triggers_from_body(body: dict) -> list:
    """grammar_lazy + grammar_triggers: [{type, value}] with type one of
    word / pattern / pattern_full / token (token values may be ids)."""
    if not body.get("grammar_lazy") and not body.get("grammar_triggers"):
        return []
    out = []
    for trig in body.get("grammar_triggers") or []:
        if isinstance(trig, str):  # bare word shorthand
            out.append({"type": "word", "value": trig})
        elif isinstance(trig, dict):
            kind = trig.get("type", "word")
            if isinstance(kind, int):  # the reference's enum numbering
                kind = {0: "token", 1: "word", 2: "pattern", 3: "pattern_full"}.get(kind, "word")
            out.append({"type": kind, "value": trig.get("value", "")})
    return out


# -- requests and responses -------------------------------------------------------

@dataclass
class Request:
    method: str
    path: str
    query: dict = field(default_factory=dict)
    headers: dict = field(default_factory=dict)  # names lower-cased
    body: bytes = b""
    match: dict = field(default_factory=dict)  # the route's {name} parts

    def json(self):
        return json.loads(self.body.decode("utf-8"))


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json; charset=utf-8"
    headers: dict = field(default_factory=dict)
    chunks: Iterator[bytes] | None = None  # a streamed body (chunked transfer)


def json_response(obj, status: int = 200) -> Response:
    return Response(status, json.dumps(obj).encode())


def text_response(text: str, status: int = 200) -> Response:
    return Response(status, text.encode(), "text/plain; charset=utf-8")


def _error(message: str, status: int, kind: str | None = None, **extra) -> Response:
    err = {"message": message, **({"type": kind} if kind else {}), **extra}
    return json_response({"error": err}, status=status)


def _not_ported(what: str, item: str) -> Response:
    return _error(f"{what} is not ported yet (ROADMAP.md {item})", 501,
                  "not_implemented_error", code=501)


# endpoints reachable without a key when an API key is set (≡ the
# reference's middleware_validate_api_key)
_PUBLIC_ENDPOINTS = {"/health", "/v1/health", "/models", "/v1/models",
                     "/api/tags", "/", "/index.html",
                     "/manifest.webmanifest", "/sw.js", "/icon.svg"}


class App:
    """A route table and the JAX server's middlewares: API-key auth, and
    a 400 with `invalid request: …` for a body that does not parse."""

    def __init__(self, api_keys: list[str] | None = None):
        self.api_keys = set(api_keys or [])
        self.routes: dict[tuple[str, str], Callable[[Request], Response]] = {}
        self.patterns: list[tuple[str, re.Pattern, Callable]] = []

    def add(self, method: str, path: str, handler: Callable[[Request], Response]):
        if "{" in path:
            rx = re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", path) + "$")
            self.patterns.append((method, rx, handler))
        else:
            self.routes[(method, path)] = handler

    def _route(self, req: Request):
        handler = self.routes.get((req.method, req.path))
        if handler is not None:
            return handler
        for method, rx, h in self.patterns:
            m = rx.match(req.path)
            if m and method == req.method:
                req.match = m.groupdict()
                return h
        known = any(p == req.path for _, p in self.routes) or \
            any(rx.match(req.path) for _, rx, _ in self.patterns)
        return 405 if known else 404

    def _authorized(self, req: Request) -> bool:
        if not self.api_keys or req.path in _PUBLIC_ENDPOINTS:
            return True
        got = req.headers.get("authorization", "") or req.headers.get("x-api-key", "")
        if got.startswith("Bearer "):
            got = got[len("Bearer "):]
        return got in self.api_keys

    def handle(self, req: Request) -> Response:
        if not self._authorized(req):
            return _error("Invalid API Key", 401, "authentication_error", code=401)
        handler = self._route(req)
        if handler == 404:
            return text_response("404: Not Found", 404)
        if handler == 405:
            return text_response("405: Method Not Allowed", 405)
        try:
            return handler(req)
        except (json.JSONDecodeError, ValueError, KeyError, TypeError) as e:
            return _error(f"invalid request: {e}", 400, "invalid_request_error")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive, chunked streams

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def log_message(self, format, *args):  # quiet, as aiohttp's access log is off
        pass

    def _dispatch(self, method: str):
        url = urlsplit(self.path)
        n = int(self.headers.get("Content-Length") or 0)
        req = Request(method, url.path, dict(parse_qsl(url.query)),
                      {k.lower(): v for k, v in self.headers.items()},
                      self.rfile.read(n) if n else b"")
        try:
            resp = self.server.app.handle(req)
        except Exception as e:  # the handler failed: a 500, the server stays up
            resp = _error(f"{type(e).__name__}: {e}", 500, "server_error")
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        for k, v in resp.headers.items():
            self.send_header(k, v)
        if resp.chunks is None:
            self.send_header("Content-Length", str(len(resp.body)))
            self.end_headers()
            self.wfile.write(resp.body)
            return
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for chunk in resp.chunks:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(chunk), chunk))
            self.wfile.flush()
        self.wfile.write(b"0\r\n\r\n")


def serve(app: App, host: str = "127.0.0.1", port: int = 8080) -> ThreadingHTTPServer:
    """`app` on a ThreadingHTTPServer bound to (host, port) (port 0: a free
    one, `server_address[1]`), serving on a daemon thread
    (`serve_forever_thread`); stop it with `.shutdown()` and
    `.server_close()`."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.app = app
    httpd.serve_forever_thread = threading.Thread(
        target=httpd.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True,
        name="tpullm-torch-http")
    httpd.serve_forever_thread.start()
    return httpd


# -- the server -------------------------------------------------------------------

def _text_only(messages: list) -> list:
    """OpenAI content blocks of text joined into one string; an image or
    audio block raises _MediaContent."""
    out = []
    for m in messages:
        content = m.get("content", "")
        if not isinstance(content, list):
            out.append(m)
            continue
        parts = []
        for block in content:
            btype = block.get("type")
            if btype == "text":
                parts.append(block.get("text", ""))
            elif btype in ("image_url", "input_audio"):
                raise _MediaContent(btype)
        out.append({**m, "content": "".join(parts)})
    return out


class _MediaContent(Exception):
    pass


class Server:
    def __init__(self, scheduler: Scheduler, model_name: str = "tpullm",
                 slot_save_path: str | None = None, api_keys: list[str] | None = None):
        self.sched = scheduler
        self.model_name = model_name
        self.slot_save_path = slot_save_path
        self.t_start = time.time()
        self.app = App(api_keys)
        add = self.app.add
        for path, what, item in (("/", "the WebUI", "1.3.5"),
                                 ("/index.html", "the WebUI", "1.3.5"),
                                 ("/manifest.webmanifest", "the WebUI", "1.3.5"),
                                 ("/sw.js", "the WebUI", "1.3.5"),
                                 ("/icon.svg", "the WebUI", "1.3.5"),
                                 ("/api/tags", "the Ollama routes", "1.3.4")):
            add("GET", path, self._deferred(what, item))
        for path, what, item in (("/api/show", "the Ollama routes", "1.3.4"),
                                 ("/rerank", "reranking", "1.3.3"),
                                 ("/reranking", "reranking", "1.3.3"),
                                 ("/v1/rerank", "reranking", "1.3.3"),
                                 ("/v1/reranking", "reranking", "1.3.3"),
                                 ("/v1/messages", "the Anthropic messages API", "1.3.1"),
                                 ("/v1/messages/count_tokens", "the Anthropic messages API",
                                  "1.3.1"),
                                 ("/v1/responses", "the responses API", "1.3.2")):
            add("POST", path, self._deferred(what, item))
        add("GET", "/health", self.health)
        add("GET", "/v1/health", self.health)  # llama.cpp alias
        add("GET", "/v1/models", self.models)
        add("GET", "/models", self.models)  # llama.cpp alias
        add("GET", "/props", self.props)
        add("GET", "/lora-adapters", self.lora_adapters)
        add("GET", "/metrics", self.metrics)
        add("GET", "/slots", self.slots)
        add("POST", "/slots/{slot_id}", self.slot_action)
        add("POST", "/tokenize", self.tokenize)
        add("POST", "/detokenize", self.detokenize)
        add("POST", "/apply-template", self.apply_template)
        add("POST", "/embedding", self.embeddings)  # llama.cpp alias
        add("POST", "/embeddings", self.embeddings)  # llama.cpp alias
        add("POST", "/v1/embeddings", self.embeddings)
        add("POST", "/infill", self.infill)
        add("POST", "/completion", self.completions)  # llama.cpp alias
        add("POST", "/completions", self.completions)  # llama.cpp alias
        add("POST", "/v1/completions", self.completions)
        add("POST", "/v1/chat/completions", self.chat_completions)
        add("POST", "/chat/completions", self.chat_completions)  # alias

    @staticmethod
    def _deferred(what: str, item: str):
        return lambda request: _not_ported(what, item)

    # -- info endpoints ------------------------------------------------------------

    def health(self, request):
        return json_response({"status": "ok"})

    def models(self, request):
        return json_response({
            "object": "list",
            "data": [{"id": self.model_name, "object": "model",
                      "created": int(self.t_start), "owned_by": "tpullm"}],
        })

    def props(self, request):
        eng = self.sched.engine
        return json_response({
            "model": self.model_name,
            "n_ctx": eng.max_seq,
            "n_slots": eng.n_slots,
            "arch": eng.hp.arch,
            "n_vocab": eng.hp.n_vocab,
        })

    def lora_adapters(self, request):
        """GET /lora-adapters: the adapters the engine wrapped at load, with
        their scales (≡ server handle_lora_adapters_list); [] for an engine
        without any (a BatchEngine has none)."""
        loras = getattr(self.sched.engine, "lora_info", []) or []
        return json_response([{"id": i, "path": p, "scale": s}
                              for i, (p, s) in enumerate(loras)])

    def metrics(self, request):
        s = self.sched
        eng = s.engine
        busy = sum(1 for x in s.slots_info() if x["state"] != "idle")
        lines = [
            "# TYPE tpullm_requests_total counter",
            f"tpullm_requests_total {s.n_requests}",
            "# TYPE tpullm_tokens_generated_total counter",
            f"tpullm_tokens_generated_total {s.n_tokens_generated}",
            "# TYPE tpullm_prompt_tokens_total counter",
            f"tpullm_prompt_tokens_total {s.n_prompt_tokens}",
            "# TYPE tpullm_slots_busy gauge",
            f"tpullm_slots_busy {busy}",
            "# TYPE tpullm_slots_total gauge",
            f"tpullm_slots_total {eng.n_slots}",
            "# TYPE tpullm_prompt_tokens_reused_total counter",
            f"tpullm_prompt_tokens_reused_total {s.n_reused_tokens}",
            "# TYPE tpullm_context_shifts_total counter",
            f"tpullm_context_shifts_total {s.n_context_shifts}",
            "# TYPE tpullm_spec_tokens_drafted_total counter",
            f"tpullm_spec_tokens_drafted_total {s.n_spec_drafted}",
            "# TYPE tpullm_spec_tokens_accepted_total counter",
            f"tpullm_spec_tokens_accepted_total {s.n_spec_accepted}",
            "# TYPE tpullm_spec_accept_rate gauge",
            f"tpullm_spec_accept_rate "
            f"{s.n_spec_accepted / s.n_spec_drafted if s.n_spec_drafted else 0.0}",
        ]
        return text_response("\n".join(lines) + "\n")

    def slots(self, request):
        return json_response(self.sched.slots_info())

    def slot_action(self, request):
        """POST /slots/:id?action=save|restore|erase (save and restore need
        --slot-save-path)."""
        slot_id = int(request.match["slot_id"])
        action = request.query.get("action", "")
        if slot_id < 0 or slot_id >= self.sched.engine.n_slots:
            return json_response({"error": {"message": "invalid slot"}}, status=400)
        if action == "erase":
            return json_response(self.sched.slot_erase(slot_id))
        if action not in ("save", "restore"):
            return json_response({"error": {"message": "unknown action"}}, status=400)
        if not self.slot_save_path:
            return json_response(
                {"error": {"message": "server started without --slot-save-path"}}, status=400)
        body = request.json()
        fname = os.path.basename(str(body.get("filename", f"slot{slot_id}.npz")))
        path = os.path.join(self.slot_save_path, fname)
        if action == "save":
            return json_response(self.sched.slot_save(slot_id, path))
        return json_response(self.sched.slot_restore(slot_id, path))

    def apply_template(self, request):
        """POST /apply-template: the chat template rendered, no generation."""
        body = request.json()
        vocab = self.sched.engine.tokenizer.vocab
        prompt = apply_chat_template(vocab.chat_template, body.get("messages", []),
                                     add_generation_prompt=True)
        return json_response({"prompt": prompt})

    def tokenize(self, request):
        body = request.json()
        ids = self.sched.engine.tokenizer.tokenize(
            body.get("content", ""), add_special=bool(body.get("add_special", False)),
            parse_special=bool(body.get("parse_special", True)),
        )
        return json_response({"tokens": ids})

    def detokenize(self, request):
        body = request.json()
        text = self.sched.engine.tokenizer.detokenize(body.get("tokens", []))
        return json_response({"content": text})

    # -- embeddings ------------------------------------------------------------------

    def embeddings(self, request):
        """OpenAI-compatible /v1/embeddings: input str or [str]."""
        body = request.json()
        inputs = body.get("input", body.get("content", ""))
        if isinstance(inputs, str):
            inputs = [inputs]
        tok = self.sched.engine.tokenizer
        data = []
        n_prompt_tokens = 0
        for i, text in enumerate(inputs):
            ids = tok.tokenize(str(text), add_special=True, parse_special=True)
            n_prompt_tokens += len(ids)
            vec = self.sched.embed(ids)
            data.append({"object": "embedding", "index": i,
                         "embedding": [float(x) for x in vec]})
        return json_response({
            "object": "list", "model": self.model_name, "data": data,
            "usage": {"prompt_tokens": n_prompt_tokens, "total_tokens": n_prompt_tokens},
        })

    # -- generation ------------------------------------------------------------------

    def infill(self, request):
        """Fill-in-the-middle completion: <fim_pre>prefix<fim_suf>suffix
        <fim_mid> from the model's FIM special tokens."""
        body = request.json()
        tok = self.sched.engine.tokenizer
        sp = tok.vocab.special
        if sp.fim_pre < 0 or sp.fim_suf < 0 or sp.fim_mid < 0:
            return json_response({"error": {"message": "model has no FIM tokens"}}, status=400)
        prefix = str(body.get("input_prefix", ""))
        suffix = str(body.get("input_suffix", ""))
        extra = str(body.get("prompt", ""))
        ids = [sp.fim_pre]
        ids += tok.tokenize(prefix + extra, add_special=False)
        ids += [sp.fim_suf]
        ids += tok.tokenize(suffix, add_special=False)
        ids += [sp.fim_mid]
        req = GenRequest(
            prompt_ids=ids,
            max_tokens=int(body.get("max_tokens", body.get("n_predict", 128))),
            sampling=_sampling_from_body(body),
            stop=body.get("stop") or [],
        )
        rid = f"infill-{uuid.uuid4().hex[:12]}"
        self.sched.submit(req)
        if body.get("stream"):
            return self._stream(req, rid, chat=False)
        text, reason, stats = self._collect(req)
        return json_response({
            "id": rid, "object": "text_completion", "created": int(time.time()),
            "model": self.model_name,
            "choices": [{"index": 0, "text": text, "finish_reason": reason}],
            "timings": stats,
        })

    def completions(self, request):
        body = request.json()
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        tok = self.sched.engine.tokenizer
        ids = tok.tokenize(prompt, add_special=True, parse_special=True)
        n_probs = int(body.get("n_probs", 0) or body.get("logprobs") or 0)
        req = GenRequest(
            prompt_ids=ids,
            max_tokens=int(body.get("max_tokens", body.get("n_predict", 128))),
            sampling=_sampling_from_body(body),
            stop=body.get("stop") or [],
            grammar=_grammar_from_body(body),
            grammar_triggers=_grammar_triggers_from_body(body),
            n_probs=n_probs,
        )
        rid = f"cmpl-{uuid.uuid4().hex[:12]}"
        self.sched.submit(req)
        if body.get("stream"):
            return self._stream(req, rid, chat=False)
        text, reason, stats, probs = self._collect_probs(req)
        choice = {"index": 0, "text": text, "finish_reason": reason}
        if n_probs:
            choice["logprobs"] = {
                "tokens": [p["token"] for p in probs],
                "token_logprobs": [p["logprob"] for p in probs],
                "top_logprobs": [{t["token"]: t["logprob"] for t in p["top"]} for p in probs],
            }
        return json_response({
            "id": rid, "object": "text_completion", "created": int(time.time()),
            "model": self.model_name,
            "choices": [choice],
            "usage": {
                "prompt_tokens": stats.get("prompt_n", len(ids)),
                "completion_tokens": stats.get("predicted_n", 0),
                "total_tokens": stats.get("prompt_n", 0) + stats.get("predicted_n", 0),
            },
            "timings": stats,
        })

    def chat_completions(self, request):
        body = request.json()
        try:
            messages = _text_only(body.get("messages", []))
        except _MediaContent as e:
            return _not_ported(f"{e.args[0]} content (multimodal)", "1.3.7")
        vocab = self.sched.engine.tokenizer.vocab
        prompt = apply_chat_template(vocab.chat_template, messages, add_generation_prompt=True,
                                     tools=body.get("tools"))
        tok = self.sched.engine.tokenizer
        ids = tok.tokenize(prompt, add_special=True, parse_special=True)
        grammar = _grammar_from_body(body)
        triggers = _grammar_triggers_from_body(body)
        tool_choice = body.get("tool_choice")
        if grammar is None and body.get("tools") and tool_choice != "none":
            # decoding constrained to a valid tool call: tool_choice=required
            # from token 0; auto lazily, from an opening <tool_call>
            grammar = tool_call_grammar(body["tools"], tool_choice)
            if not (tool_choice == "required" or isinstance(tool_choice, dict)):
                triggers = [{"type": "word", "value": "<tool_call>"}]
        req = GenRequest(
            prompt_ids=ids,
            max_tokens=int(body.get("max_tokens", 128)),
            sampling=_sampling_from_body(body),
            stop=body.get("stop") or [],
            grammar=grammar,
            grammar_triggers=triggers,
        )
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        self.sched.submit(req)
        if body.get("stream"):
            return self._stream(req, rid, chat=True, tools=bool(body.get("tools")))
        text, reason, stats = self._collect(req)
        # tool-call and reasoning extraction (≡ common/chat-parser)
        reasoning, text = extract_reasoning(text)
        tool_calls = []
        if body.get("tools"):
            text, tool_calls = parse_tool_calls(text)
        message = {"role": "assistant", "content": text or None}
        if reasoning is not None:
            message["reasoning_content"] = reasoning
        if tool_calls:
            message["tool_calls"] = tool_calls
            reason = "tool_calls"
        return json_response({
            "id": rid, "object": "chat.completion", "created": int(time.time()),
            "model": self.model_name,
            "choices": [{"index": 0, "message": message, "finish_reason": reason}],
            "usage": {
                "prompt_tokens": stats.get("prompt_n", len(ids)),
                "completion_tokens": stats.get("predicted_n", 0),
                "total_tokens": stats.get("prompt_n", 0) + stats.get("predicted_n", 0),
            },
            "timings": stats,
        })

    @staticmethod
    def _events(req: GenRequest):
        """The request's events up to and including its ("done", ...)."""
        while True:
            try:
                ev = req.out.get(timeout=EVENT_TIMEOUT_S)
            except queue.Empty:
                raise TimeoutError(f"no event from request {req.id} in {EVENT_TIMEOUT_S} s")
            yield ev
            if ev[0] != "token":
                return

    def _collect(self, req: GenRequest):
        text, reason, stats, _ = self._collect_probs(req)
        return text, reason, stats

    def _collect_probs(self, req: GenRequest):
        pieces, probs = [], []
        for ev in self._events(req):
            if ev[0] == "token":
                pieces.append(ev[2])
                if len(ev) > 3:
                    probs.append({"token": ev[2], **ev[3]})
            else:
                return "".join(pieces), ev[1], ev[2], probs

    def _stream(self, req: GenRequest, rid: str, chat: bool, tools: bool = False) -> Response:
        obj = "chat.completion.chunk" if chat else "text_completion"
        # tool-call argument streaming: content and tool_calls deltas split
        # as tokens arrive
        parser = StreamingToolCallParser() if chat and tools else None

        def emit(delta_obj) -> bytes:
            delta_obj.update({"id": rid, "object": obj, "model": self.model_name})
            return f"data: {json.dumps(delta_obj)}\n\n".encode()

        def emit_events(events):
            for kind, *rest in events:
                if kind == "content":
                    d = {"content": rest[0]}
                elif kind == "tool_start":
                    idx, name = rest
                    d = {"tool_calls": [{"index": idx, "id": f"call_{idx}", "type": "function",
                                         "function": {"name": name, "arguments": ""}}]}
                else:  # tool_args
                    idx, args_delta = rest
                    d = {"tool_calls": [{"index": idx, "function": {"arguments": args_delta}}]}
                yield emit({"choices": [{"index": 0, "delta": d, "finish_reason": None}]})

        def chunks():
            for ev in self._events(req):
                if ev[0] == "token":
                    if parser is not None:
                        yield from emit_events(parser.feed(ev[2]))
                    elif chat:
                        yield emit({"choices": [{"index": 0, "delta": {"content": ev[2]},
                                                 "finish_reason": None}]})
                    else:
                        yield emit({"choices": [{"index": 0, "text": ev[2],
                                                 "finish_reason": None}]})
                    continue
                reason = ev[1]
                if parser is not None:
                    yield from emit_events(parser.flush())
                    if parser.saw_tool_call:
                        reason = "tool_calls"
                final = {"id": rid, "object": obj, "model": self.model_name,
                         "choices": [{"index": 0, "finish_reason": reason,
                                      **({"delta": {}} if chat else {"text": ""})}],
                         "timings": ev[2]}
                yield f"data: {json.dumps(final)}\n\n".encode()
                yield b"data: [DONE]\n\n"

        return Response(200, content_type="text/event-stream",
                        headers={"Cache-Control": "no-cache"}, chunks=chunks())


def make_app(model_path, slot_save_path: str | None = None, spec_type: str | None = None,
             draft_model_path=None, n_draft: int = 8, cache_reuse: int = 0,
             api_keys: list[str] | None = None, **engine_kw) -> tuple[App, Scheduler]:
    """A BatchEngine on `model_path`, its Scheduler started (speculative
    with `spec_type` or a draft model), and the Server's App (serve it
    with `serve`)."""
    from ..runtime.batch_engine import BatchEngine

    engine = BatchEngine(model_path, **engine_kw)
    draft_engine = None
    if draft_model_path is not None:
        # the draft model shares the target's slot layout, so one batched
        # draft step serves every speculating slot (≡ server -md)
        draft_engine = BatchEngine(draft_model_path, **engine_kw)
    sched = Scheduler(engine, spec_type=spec_type, draft_engine=draft_engine, n_draft=n_draft,
                      cache_reuse=cache_reuse)
    sched.start()
    return Server(sched, slot_save_path=slot_save_path, api_keys=api_keys).app, sched
