"""Card readings behind chip_smoke.py's moe families holds, and the cost of
Llama 4's chunk route (run on a machine with an NVIDIA GPU, from the repo
root:
`python3 tests/torch_moe_families_witness.py`; it builds the kernels as
chip_smoke.py does, ≈ 5 min with the build):

1. OLMoE-1B-7B's joint prefill round: the 40-token prompt's last row
   through the forward, layer by layer, in a joint round of 40 / 40 / 500
   and of 40 / 200 / 500 tokens, in one forward of 512 rows and in one of
   2 × 64, each against Engine's own forward of 64 rows (NMSE of the
   attention block's output, the MoE input and output after each layer,
   and of the logits); the two 40-token slots of one joint forward against
   each other.
2. Phi-3.5-MoE against dense bf16 weights under the packed engine's own
   sparsemixer choices (chip_smoke.sparsemixer_against_dense) at 1, 2 and 8
   layers.
3. The chunked layers' dense route at Llama-4-Scout's heads (40 on 8 of
   128) over a cache of 8448 slots, a chunk of 8192: attention_chunked
   (and the chunk mask it takes, made once a forward) beside the flash
   kernel's causal attention at the same shapes, at a decode row (kv 8301)
   and a 512-row prefill crossing the chunk boundary (offset 7936), as
   CUDA-graph replays.

Not a pytest file: its readings are recorded in PERF.md."""

import gc
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _nmse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2) / (np.mean(b * b) or 1.0))


def olmoe_rows(tmp: Path) -> None:
    import torch

    from tpullm_torch.models import qwen_moe
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import make_cache

    record = []
    moe_ffn, attn_block = qwen_moe.moe_ffn, qwen_moe.attn_block

    def moe_spy(hs, *a, **k):
        out = moe_ffn(hs, *a, **k)
        record.extend([("moe in", hs.float().cpu().numpy()),
                       ("moe out", out.float().cpu().numpy())])
        return out

    def attn_spy(hp, layer, x, *a, **k):
        y, cache = attn_block(hp, layer, x, *a, **k)
        record.append(("attn out", y.float().reshape(-1, y.shape[-1]).cpu().numpy()))
        return y, cache

    qwen_moe.moe_ffn, qwen_moe.attn_block = moe_spy, attn_spy
    try:
        path = cs.synthesize(tmp, "witness", "olmoe-1b-7b", "Q4_K_M", vocab="bpe")
        eng = Engine(path, max_seq=4096)
        hp = eng.hp
        p40, p200, p500 = (cs._word_ids(eng.tokenizer, n) for n in (40, 200, 500))

        def forward(prompts, bucket):
            B = len(prompts)
            toks = np.zeros((B, bucket), np.int64)
            for i, p in enumerate(prompts):
                toks[i, :len(p)] = p
            pos = np.broadcast_to(np.arange(bucket), (B, bucket)).copy()
            cache = make_cache(hp, B, 4096, torch.bfloat16, eng.device)
            record.clear()
            with torch.inference_mode():
                logits, _ = eng.arch.forward(
                    hp, eng.params, torch.from_numpy(toks).to(eng.device),
                    torch.from_numpy(pos).to(eng.device), cache,
                    torch.zeros(B, dtype=torch.int32, device=eng.device),
                    last_index=torch.tensor([len(p) - 1 for p in prompts], device=eng.device))
            return logits[:, 0].float().cpu().numpy(), list(record)

        ref, ref_steps = forward([p40], 64)
        for label, prompts, bucket in (("joint 40/40/500", [p40, p40, p500], 512),
                                       ("joint 40/200/500", [p40, p200, p500], 512),
                                       ("one forward of 512 rows", [p40], 512),
                                       ("joint 40/40 of 64 rows each", [p40, p40], 64)):
            got, steps = forward(prompts, bucket)
            twin = _nmse(got[0], got[1]) if prompts[1:2] == [p40] else None
            cs.log(f"[witness] olmoe {label}: the 40-token row's logits against Engine's forward "
                   f"of 64 rows {_nmse(got[0], ref[0]):.3e}; the two 40-token slots "
                   f"{'' if twin is None else f'{twin:.3e}'}")
            by_layer = [f"{n} {_nmse(a[39], b[39]):.1e}"
                        for (n, a), (_, b) in zip(steps, ref_steps)]
            cs.log(f"[witness] olmoe {label}, row 39 by layer: {by_layer}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        path.unlink()
    finally:
        qwen_moe.moe_ffn, qwen_moe.attn_block = moe_ffn, attn_block


def phimoe_depth(tmp: Path) -> None:
    import torch

    for n_layer in (1, 2, cs.PHIMOE_LAYERS):
        path = cs.synthesize(tmp, "witness", "phi-3.5-moe", "Q4_K_M", n_layer=n_layer)
        got = cs.sparsemixer_against_dense(f"phi-3.5-moe-{n_layer}l", path, cs.MOE_FAMILY_CTX,
                                           cs.PHIMOE_DENSE_POSITIONS)
        cs.log(f"[witness] phi-3.5-moe {n_layer} layers against dense weights: {got}")
        gc.collect()
        torch.cuda.empty_cache()
        path.unlink()


def chunk_route_cost() -> None:
    import torch

    from tpullm_torch.ops import attention
    from tpullm_torch.runtime.kvcache import KVCache

    dev = torch.device("cuda", 0)
    H, Hkv, D, S, W = 40, 8, 128, 8448, 8192
    gen = torch.Generator(dev).manual_seed(7)
    k, v = (torch.randn(1, 1, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    cache = KVCache(k, v)
    for T, off in ((1, 8300), (512, 7936)):
        q = torch.randn(1, T, H, D, generator=gen, device=dev).to(torch.bfloat16)
        offsets = torch.tensor([off], dtype=torch.int32, device=dev)
        pos = (off + torch.arange(T, device=dev))[None]
        mask = attention.chunk_mask(pos, offsets, S, W)
        mask_ms = cs.time_ms(lambda: attention.chunk_mask(pos, offsets, S, W), 20)
        dense_ms = cs.time_ms(lambda: attention.attention_chunked(q, cache, 0, mask, D ** -0.5),
                              20)
        flash_ms = cs.time_ms(lambda: attention.attention_cached(q, cache, 0, D ** -0.5, offsets),
                              20)
        cs.log(f"[witness] chunk route, 40 heads on 8 of 128, cache {S}, chunk {W}, T={T} at "
               f"offset {off}: attention_chunked {dense_ms:.4f} ms (its mask {mask_ms:.4f} ms a "
               f"forward), flash (causal) {flash_ms:.4f} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    held = []
    cs.expect = lambda cond, msg: held.append(msg) if not cond else None  # readings, not checks
    print(cs.phase_card(), flush=True)
    cs.phase_build()
    with tempfile.TemporaryDirectory(prefix="tpullm_torch_witness_") as tmp:
        olmoe_rows(Path(tmp))
        phimoe_depth(Path(tmp))
    chunk_route_cost()
    for msg in held:
        cs.log(f"[witness] outside chip_smoke.py's bound: {msg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
