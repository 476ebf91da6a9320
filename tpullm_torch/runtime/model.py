"""Loaded-model handle shared across engines (the JAX package's
runtime/model.py; ≡ llama_model against llama_context: load the model
once, make many contexts from it).

`Model` owns the GGUF reader, the hparams, the tokenizer and the
device-resident params (packed planes repacked on the card). `Engine` and
`BatchEngine` take a Model wherever they take a path and then hold only
their own state: the cache, the graph runners and the counters. The
weights cross to the card once a process, so a second engine on the same
model costs its cache, not a second load.

Fusion follows the JAX package's rules: a Model loads its linears apart,
and the first plain engine on it fuses q|k|v and gate|up once, in place
(`fused`), for every engine after it; an engine with LoRA adapters or
control vectors needs the named projections, so it takes an unfused Model
with its tree's structure copied (the tensors stay shared) and refuses a
fused one. A Model always loads unfused: an engine that loads its own
fuses it unless it carries an adapter, as the JAX Engine's own load does.
"""

from __future__ import annotations

import time

import torch

from .. import tokenizer as tokenizer_mod
from ..device import resolve_device
from ..gguf.reader import GGUFReader
from ..models.registry import get_arch, load_hparams
from ..models.weights import fuse_llama_params


class Model:
    """Weights and metadata of one GGUF, loaded once onto `device` (None:
    the card), in the weight `mode` and activation `dtype` of Engine's."""

    def __init__(self, model_path, *, device=None, mode: str = "auto",
                 dtype=torch.bfloat16, override_kv: dict | None = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"dtype {dtype}: on the card the flash kernels take bf16 "
                             "queries, so the activations are bf16")
        t0 = time.perf_counter()
        self.path = model_path
        self.reader = GGUFReader(model_path)
        if override_kv:
            self.reader.metadata.update(override_kv)
        self.hp = load_hparams(self.reader)
        self.arch = get_arch(self.hp.arch)
        self.tokenizer = tokenizer_mod.from_gguf(self.reader)
        self.mode, self.dtype = mode, dtype
        with torch.inference_mode():
            self.params = self.arch.build_params(self.reader, self.hp, self.device, dtype, mode)
        self.is_fused = False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the load includes the repack
        self.t_load_s = time.perf_counter() - t0

    def fused(self) -> dict:
        """The params with q|k|v and gate|up fused where they share a type,
        fused once, in place (the unfused linears are dropped, so the planes
        are not held twice), and shared by every plain engine after."""
        if not self.is_fused:
            with torch.inference_mode():
                fuse_llama_params(self.params)
            self.is_fused = True
        return self.params

    def unfused_view(self) -> dict:
        """The params of an engine with adapters or control vectors: the
        tree's structure copied (its tensors shared), so that wrapping a
        linear or adding "cvec" leaves the Model as it is. A fused Model
        has lost the named projections the adapters target: it raises."""
        if self.is_fused:
            raise ValueError("Model already fused by a plain engine; load a separate Model "
                             "for LoRA/cvec use")
        return {**self.params, "layers": [dict(layer) for layer in self.params["layers"]]}

    @classmethod
    def of(cls, model_path, device, mode: str, dtype, override_kv: dict | None = None):
        """`model_path` itself where it is a Model (an engine's mode other
        than "auto" and its device must be the Model's; override_kv belongs
        to the Model's load), else a Model loaded from the path."""
        if not isinstance(model_path, cls):
            return cls(model_path, device=device, mode=mode, dtype=dtype,
                       override_kv=override_kv)
        if mode != "auto" and (mode, dtype) != (model_path.mode, model_path.dtype):
            raise ValueError(f"engine asked for mode={mode!r}/dtype={dtype}, but this Model was "
                             f"loaded with mode={model_path.mode!r}/dtype={model_path.dtype}: "
                             "load a separate Model for that configuration")
        if override_kv:
            raise ValueError("override_kv must be applied when loading the Model")
        if device is not None and resolve_device(device) != model_path.device:
            raise ValueError(f"engine asked for device {device}, but this Model is on "
                             f"{model_path.device}")
        return model_path
