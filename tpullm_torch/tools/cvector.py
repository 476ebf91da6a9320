"""tpullm-torch-cvector-generator: control vectors, load/save and the
generator (the JAX package's tools/cvector.py on the port's Engine).

Reference: llama_adapter_cvec (src/llama-adapter.cpp; GGUF tensors
"direction.<layer>" [n_embd] f32, 1-based layers, scaled by strength and
added to each layer's residual stream) and tools/cvector-generator
(cvector-generator.cpp: per-layer hidden states of positive vs negative
prompts → mean-diff or PCA direction).

The per-layer hidden states come from the port's llama forward itself
(models/llama.py `forward(..., layer_states=[])`: x after every layer, of
an Engine on dense bf16 weights, as the JAX generator loads its Engine;
on the card its attention runs in the flash kernel), each prompt's mean
over its tokens.

    python -m tpullm_torch.tools.cvector -m model.gguf \\
        --positive-file pos.txt --negative-file neg.txt -o cv.gguf --method pca
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_control_vector(path, n_layer: int, strength: float = 1.0) -> np.ndarray:
    """direction.N tensors → [n_layer, n_embd] f32 (missing layers zero)."""
    from ..gguf.reader import GGUFReader

    r = GGUFReader(path)
    dirs = {}
    n_embd = None
    for name, info in r.tensors.items():
        if not name.startswith("direction."):
            continue
        layer = int(name.split(".")[1])  # 1-based (layer 0 is the embedding)
        vec = np.array(info.to_numpy(), dtype=np.float32).reshape(-1)
        n_embd = len(vec) if n_embd is None else n_embd
        if len(vec) != n_embd:
            raise ValueError(f"{name}: inconsistent n_embd")
        dirs[layer] = dirs.get(layer, 0.0) + vec
    r.close()
    if not dirs:
        raise ValueError(f"no direction tensors in {path}")
    out = np.zeros((n_layer, n_embd), dtype=np.float32)
    for layer, vec in dirs.items():
        if 1 <= layer <= n_layer:
            out[layer - 1] = vec * strength
    return out


def save_control_vector(path, directions: np.ndarray, arch: str = "controlvector"):
    """directions: [n_layer, n_embd]; written as direction.1..direction.N."""
    from ..gguf.writer import GGUFWriter

    w = GGUFWriter(path, architecture=arch)
    w.add_kv("general.type", "controlvector")
    for i, vec in enumerate(directions):
        if np.any(vec):
            w.add_tensor(f"direction.{i + 1}", np.asarray(vec, dtype=np.float32))
    w.write()
    return str(path)


def layer_states(engine, text: str) -> np.ndarray:
    """The mean hidden state after every layer of the llama graph over the
    tokens of `text`: [n_layer, n_embd] f32 (the reference's cb_eval l_out
    hook). One throwaway forward from slot 0 (the head skipped); n_past is
    0 after."""
    import torch

    from ..models import llama

    if engine.arch.forward is not llama.forward:
        raise NotImplementedError("cvector generation supports the llama family")
    ids = engine.tokenizer.tokenize(text, add_special=True)
    engine.reset()
    states: list = []
    with torch.inference_mode():
        toks = engine._padded(ids)
        _, engine.cache = llama.forward(engine.hp, engine.params, toks,
                                        engine._positions(0, toks.shape[1]), engine.cache, 0,
                                        return_hidden=True, layer_states=states)
        out = torch.stack([x[0, :len(ids)].float().mean(dim=0) for x in states])
        got = out.cpu().numpy()
    engine.reset()
    return got


def directions(pos: np.ndarray, neg: np.ndarray, method: str = "mean") -> np.ndarray:
    """[n_layer, n_embd] directions from the per-prompt layer states pos
    [P, L, E] and neg [N, L, E]: the difference of their means ("mean"), or
    the first principal component of the per-pair differences, per layer,
    sign-aligned with the mean difference and scaled to its norm ("pca";
    the mean difference where a layer's pairs do not vary)."""
    diffs = pos.mean(axis=0) - neg.mean(axis=0)  # [L, E]
    if method == "mean":
        return diffs.astype(np.float32)
    if method != "pca":
        raise ValueError(method)
    n = min(len(pos), len(neg))
    pair_diffs = pos[:n] - neg[:n]  # [n, L, E]
    dirs = np.zeros_like(diffs)
    for li in range(pair_diffs.shape[1]):
        d = pair_diffs[:, li, :]
        d = d - d.mean(axis=0)
        if n == 1 or not np.any(d):
            dirs[li] = diffs[li]
            continue
        _, _, vt = np.linalg.svd(d, full_matrices=False)
        v = vt[0]
        if np.dot(v, diffs[li]) < 0:
            v = -v
        dirs[li] = v * np.linalg.norm(diffs[li])
    return dirs.astype(np.float32)


def generate_control_vector(model_path, positive: list[str], negative: list[str],
                            method: str = "mean", device=None) -> np.ndarray:
    """[n_layer, n_embd] steering directions from prompt pairs, on a
    dense-weight Engine of `model_path` (a path or a loaded Model; `device`
    None: the card)."""
    import torch

    from ..runtime.engine import Engine
    from ..runtime.model import Model

    model = Model.of(model_path, device, "dense", torch.bfloat16)
    longest = max(len(model.tokenizer.tokenize(p, add_special=True))
                  for p in positive + negative)
    engine = Engine(model, max_seq=longest)  # the prompts unpadded: one bucket of the longest
    pos = np.stack([layer_states(engine, p) for p in positive])  # [P, L, E]
    neg = np.stack([layer_states(engine, p) for p in negative])
    return directions(pos, neg, method)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-cvector-generator")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their plain versions)")
    ap.add_argument("--positive-file", required=True,
                    help="file of positive prompts, one per line")
    ap.add_argument("--negative-file", required=True)
    ap.add_argument("-o", "--output", default="control_vector.gguf")
    ap.add_argument("--method", choices=["mean", "pca"], default="pca")
    args = ap.parse_args(argv)
    positive = [l for l in open(args.positive_file).read().splitlines() if l.strip()]
    negative = [l for l in open(args.negative_file).read().splitlines() if l.strip()]
    dirs = generate_control_vector(args.model, positive, negative, args.method, args.device)
    save_control_vector(args.output, dirs)
    print(f"wrote {args.output} ({(np.any(dirs, axis=1)).sum()} layer directions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
