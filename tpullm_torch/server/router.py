"""Multi-model router (the JAX package's server/router.py: the /models
registry that switches on the request's "model" field), in process.

Each model gets its own BatchEngine, Scheduler and Server, made at its
first use; `max_loaded` bounds the resident models, the least recently used
unloaded first. Unloading stops the scheduler, drops the engine's decode
graphs and hands the freed memory back to the card
(`torch.cuda.empty_cache`) before the next model loads.
"""

from __future__ import annotations

import threading
import time

import torch

from .api import App, Request, Server, json_response
from .scheduler import Scheduler

# the routes proxied to a model's server (its handler's name), by the
# body's "model" field
PROXIED = {
    "/v1/completions": "completions",
    "/completion": "completions",
    "/v1/chat/completions": "chat_completions",
    "/v1/embeddings": "embeddings",
    "/embedding": "embeddings",
    "/tokenize": "tokenize",
    "/detokenize": "detokenize",
}
# the JAX router's other routes, answered with a 501 (what, ROADMAP.md item)
DEFERRED = {
    "/v1/rerank": ("reranking", "1.3.3"),
    "/rerank": ("reranking", "1.3.3"),
    "/v1/messages": ("the Anthropic messages API", "1.3.1"),
    "/v1/messages/count_tokens": ("the Anthropic messages API", "1.3.1"),
}


class ModelEntry:
    def __init__(self, name: str, path: str, engine_kw: dict):
        self.name = name
        self.path = path
        self.engine_kw = engine_kw
        self.server: Server | None = None
        self.sched: Scheduler | None = None
        self.last_used = 0.0

    @property
    def loaded(self) -> bool:
        return self.server is not None


class Router:
    def __init__(self, models: dict[str, str], max_loaded: int = 1,
                 api_keys: list[str] | None = None, **engine_kw):
        self.entries = {name: ModelEntry(name, path, engine_kw)
                        for name, path in models.items()}
        if not self.entries:
            raise ValueError("router needs at least one model")
        self.default = next(iter(self.entries))
        self.max_loaded = max_loaded
        self._lock = threading.Lock()  # one load or unload at a time
        self.app = App(api_keys)
        add = self.app.add
        add("GET", "/health", self.health)
        add("GET", "/v1/models", self.models)
        add("GET", "/models", self.models)
        add("POST", "/models/{name}/load", self.load_model)
        add("POST", "/models/{name}/unload", self.unload_model)
        for route in PROXIED:
            add("POST", route, self.proxy)
        for route, (what, item) in DEFERRED.items():
            add("POST", route, Server._deferred(what, item))

    # -- lifecycle ----------------------------------------------------------------

    def _ensure_loaded(self, name: str) -> ModelEntry:
        from ..runtime.batch_engine import BatchEngine

        with self._lock:
            entry = self.entries.get(name) or self.entries[self.default]
            if not entry.loaded:
                self._evict_for(entry)
                engine = BatchEngine(entry.path, **entry.engine_kw)
                entry.sched = Scheduler(engine)
                entry.sched.start()
                entry.server = Server(entry.sched, model_name=entry.name)
            entry.last_used = time.time()
            return entry

    def _evict_for(self, incoming: ModelEntry):
        loaded = [e for e in self.entries.values() if e.loaded]
        while len(loaded) >= self.max_loaded:
            victim = min(loaded, key=lambda e: e.last_used)
            self._unload(victim)
            loaded.remove(victim)

    def _unload(self, entry: ModelEntry):
        sched, entry.sched, entry.server = entry.sched, None, None
        if sched is None:
            return
        sched.stop()
        sched.engine.drop_graphs()
        cuda = sched.engine.device.type == "cuda"
        del sched  # the last reference to the engine: its weights and cache go
        if cuda:
            torch.cuda.empty_cache()

    def shutdown(self):
        with self._lock:
            for entry in self.entries.values():
                self._unload(entry)

    # -- handlers -----------------------------------------------------------------

    def health(self, request):
        return json_response({"status": "ok"})

    def models(self, request):
        return json_response({
            "object": "list",
            "data": [
                {"id": e.name, "object": "model", "owned_by": "tpullm",
                 "meta": {"path": e.path, "loaded": e.loaded}}
                for e in self.entries.values()
            ],
        })

    def load_model(self, request):
        name = request.match["name"]
        if name not in self.entries:
            return json_response({"error": {"message": f"unknown model {name}"}}, status=404)
        self._ensure_loaded(name)
        return json_response({"model": name, "loaded": True})

    def unload_model(self, request):
        name = request.match["name"]
        entry = self.entries.get(name)
        if entry is None:
            return json_response({"error": {"message": f"unknown model {name}"}}, status=404)
        with self._lock:
            self._unload(entry)
        return json_response({"model": name, "loaded": False})

    def proxy(self, request: Request):
        """Dispatch by the request body's "model" field (default: the first)."""
        body = request.json()
        entry = self._ensure_loaded(str(body.get("model") or self.default))
        return getattr(entry.server, PROXIED[request.path])(request)


def make_router_app(models: dict[str, str], max_loaded: int = 1,
                    api_keys: list[str] | None = None, **engine_kw) -> Router:
    return Router(models, max_loaded=max_loaded, api_keys=api_keys, **engine_kw)
