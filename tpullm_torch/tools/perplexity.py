"""tpullm-torch-perplexity: PPL over a text corpus, KL-divergence against
recorded base logits and multiple-choice scoring (≡ reference
tools/perplexity), the JAX package's tools/perplexity.py on the port's
Engine.

The numbers, the window rule and the npz format are the reference's: the
corpus is tokenized, split into n_ctx windows, the first half of each
window is context only (first_eval = n_ctx // 2), and the NLL is summed
over the second half. Each window is a fresh sequence: `engine.reset()`,
whose cache is then rewritten from slot 0 in place. The logits of a window
stay on the device (`Engine.prefill_all_logits_device`: at the 8B's vocab
one 512-token window is 263 MB of f32): the log-softmax and the gather of
the targets run there, and only the NLL values come back. A mean NLL past
f64's range gives a PPL of inf, as llama.cpp's std::exp does (the JAX
tool's math.exp raises OverflowError there).

    python -m tpullm_torch.tools.perplexity -m model.gguf -f SURVEY.md -c 512 --max-windows 4
"""

from __future__ import annotations

import argparse
import json
import math
import sys

_MAX_LOG = math.log(sys.float_info.max)  # exp overflows f64 past this

import numpy as np
import torch


def _ppl(nll: float, count: int) -> float:
    """exp of the mean NLL; inf past f64's range."""
    mean = nll / max(count, 1)
    return math.exp(mean) if mean < _MAX_LOG else math.inf


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """[T, V] f32 log-probabilities, in the reference's steps: x − (m +
    log Σ exp(x − m)), m the row max."""
    m = logits.amax(dim=-1, keepdim=True)
    return logits - (m + torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True)))


def _target_logprobs(logits: torch.Tensor, rows: range, targets: list[int]) -> list[float]:
    """log p(targets[i] | row rows[i]) read back as floats (only these
    values leave the device)."""
    logp = _log_softmax(logits[rows.start:rows.stop])
    idx = torch.tensor(targets, dtype=torch.int64, device=logits.device)[:, None]
    return logp.gather(1, idx)[:, 0].tolist()


def perplexity(engine, text: str, n_ctx: int = 512, max_windows: int | None = None,
               progress=lambda *a: None):
    tok = engine.tokenizer
    ids = tok.tokenize(text, add_special=True)
    n_win = len(ids) // n_ctx
    if max_windows:
        n_win = min(n_win, max_windows)
    if n_win == 0:
        raise ValueError(f"corpus too short: {len(ids)} tokens < n_ctx {n_ctx}")

    nll = 0.0
    count = 0
    first_eval = n_ctx // 2
    for wi in range(n_win):
        window = ids[wi * n_ctx : (wi + 1) * n_ctx]
        engine.reset()
        logits = engine.prefill_all_logits_device(window)
        for lp in _target_logprobs(logits, range(first_eval, n_ctx - 1),
                                   window[first_eval + 1:n_ctx]):
            nll -= lp
            count += 1
        progress(wi + 1, n_win, _ppl(nll, count))
    return _ppl(nll, count), count


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


def kl_divergence(logits_a: np.ndarray, logits_b: np.ndarray) -> float:
    """Mean token KLD between two logit sets [T, V] (≡ --kl-divergence)."""
    la = logits_a - _logsumexp(logits_a)
    lb = logits_b - _logsumexp(logits_b)
    return float(np.mean(np.sum(np.exp(la) * (la - lb), axis=-1)))


def _window_logits(engine, text: str, n_ctx: int, max_windows: int | None):
    """All-position logits per perplexity window, as f16 [n_win, n_ctx, V]."""
    ids = engine.tokenizer.tokenize(text, add_special=True)
    n_win = len(ids) // n_ctx
    if max_windows:
        n_win = min(n_win, max_windows)
    out = []
    for wi in range(n_win):
        window = ids[wi * n_ctx : (wi + 1) * n_ctx]
        engine.reset()
        out.append(engine.prefill_all_logits_device(window).to(torch.float16).cpu().numpy())
    return np.stack(out), ids[: n_win * n_ctx]


def save_logits_base(engine, text: str, path: str, n_ctx: int = 512,
                     max_windows: int | None = None):
    """Record a run's logits for later KLD comparison
    (≡ perplexity --kl-divergence-base output), uncompressed (np.savez:
    deflating four 512-token windows of a 128256-token vocab's f16 logits
    took over a minute; the JAX package deflates, and np.load reads
    either)."""
    logits, ids = _window_logits(engine, text, n_ctx, max_windows)
    np.savez(path, logits=logits, ids=np.asarray(ids, np.int64), n_ctx=n_ctx)
    return path


def kld_vs_base(engine, text: str, base_path: str,
                max_windows: int | None = None) -> dict:
    """KL divergence of this model's token distributions against a recorded
    base run (≡ perplexity --kl-divergence): quantifies quantization loss
    without needing the base model loaded. This run's logits are rounded to
    f16 as the base's were, and each window's KLD and top-1 agreement are
    taken on the device."""
    with np.load(base_path) as z:
        n_ctx = int(z["n_ctx"])
        base_all = z["logits"]
        base_ids = z["ids"]
    n_win = max_windows or base_all.shape[0]
    ids = engine.tokenizer.tokenize(text, add_special=True)
    n_win = min(n_win, len(ids) // n_ctx)
    ids = ids[: n_win * n_ctx]
    if list(base_ids[: len(ids)]) != list(ids):
        raise ValueError("base run tokenization differs (different model vocab?)")
    kld_sum, same, n_tok = 0.0, 0, 0
    for wi in range(n_win):
        engine.reset()
        ours = engine.prefill_all_logits_device(ids[wi * n_ctx:(wi + 1) * n_ctx])
        ours = ours.to(torch.float16).float()
        base = torch.from_numpy(base_all[wi]).to(ours.device).float()
        lb, la = _log_softmax(base), _log_softmax(ours)
        kld_sum += float((torch.exp(lb) * (lb - la)).sum(dim=-1).double().sum())
        same += int((base.argmax(-1) == ours.argmax(-1)).sum())
        n_tok += ours.shape[0]
    return {"kld": kld_sum / n_tok, "same_top_p": same / n_tok, "n_tokens": n_tok}


def choice_logprob(engine, context_ids: list[int], ending_ids: list[int],
                   normalize: bool = True) -> float:
    """Sum (length-normalized) log P(ending | context) — the scoring unit of
    the reference's HellaSwag/Winogrande/MMLU evaluators (perplexity.cpp)."""
    ids = context_ids + ending_ids
    engine.reset()
    logits = engine.prefill_all_logits_device(ids)
    start = len(context_ids)
    total = 0.0
    for lp in _target_logprobs(logits, range(start - 1, len(ids) - 1), ids[start:]):
        total += lp
    return total / len(ending_ids) if normalize else total


def multiple_choice_accuracy(engine, tasks: list[dict],
                             progress=lambda *a: None) -> float:
    """tasks: [{"context": str, "endings": [str...], "label": int}] → accuracy
    (≡ perplexity.cpp hellaswag_score / multiple_choice_score)."""
    tok = engine.tokenizer
    correct = 0
    for i, task in enumerate(tasks):
        ctx_ids = tok.tokenize(task["context"], add_special=True)
        scores = []
        for ending in task["endings"]:
            full = tok.tokenize(task["context"] + ending, add_special=True)
            ending_ids = full[len(ctx_ids):]
            if not ending_ids:  # ending merged into context tokens entirely
                scores.append(float("-inf"))
                continue
            scores.append(choice_logprob(engine, full[: len(ctx_ids)], ending_ids))
        if int(np.argmax(scores)) == int(task["label"]):
            correct += 1
        progress(i + 1, len(tasks), correct / (i + 1))
    return correct / len(tasks)


def _read(path: str) -> str:
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-perplexity",
                                 description="Perplexity over a text file")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", required=True)
    ap.add_argument("-c", "--ctx", type=int, default=512)
    ap.add_argument("--max-windows", type=int, default=None)
    ap.add_argument("--mode", default="auto", choices=["auto", "quant", "dense"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their plain versions)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--multiple-choice", action="store_true",
                    help="treat FILE as jsonl tasks "
                         '{"context","endings","label"} (hellaswag-style)')
    ap.add_argument("--kl-divergence-base", metavar="NPZ",
                    help="record this run's logits to NPZ for later KLD runs")
    ap.add_argument("--kl-divergence", metavar="NPZ",
                    help="compare this run's logits against a recorded base")
    args = ap.parse_args(argv)

    from ..runtime.engine import Engine

    engine = Engine(args.model, device=args.device, mode=args.mode, max_seq=max(args.ctx, 512))
    if args.kl_divergence_base:
        save_logits_base(engine, _read(args.file), args.kl_divergence_base,
                         n_ctx=args.ctx, max_windows=args.max_windows)
        print(f"logits base saved to {args.kl_divergence_base}")
        return 0
    if args.kl_divergence:
        res = kld_vs_base(engine, _read(args.file), args.kl_divergence,
                          max_windows=args.max_windows)
        print(json.dumps(res) if args.json else
              f"KLD = {res['kld']:.6f}  same-top = {res['same_top_p']:.4f} "
              f"over {res['n_tokens']} tokens")
        return 0
    if args.multiple_choice:
        tasks = [json.loads(line) for line in _read(args.file).splitlines() if line.strip()]
        acc = multiple_choice_accuracy(
            engine, tasks,
            progress=lambda i, n, a: print(f"[{i}/{n}] acc={a:.3f}",
                                           file=sys.stderr, flush=True),
        )
        print(json.dumps({"accuracy": acc, "n_tasks": len(tasks)})
              if args.json else f"accuracy = {acc:.4f} over {len(tasks)} tasks")
        return 0

    def prog(i, n, ppl):
        print(f"[{i}/{n}] ppl={ppl:.4f}", file=sys.stderr, flush=True)

    ppl, n_tokens = perplexity(engine, _read(args.file), n_ctx=args.ctx,
                               max_windows=args.max_windows, progress=prog)
    if args.json:
        print(json.dumps({"ppl": ppl, "n_tokens": n_tokens, "n_ctx": args.ctx}))
    else:
        print(f"PPL = {ppl:.4f} over {n_tokens} tokens (n_ctx={args.ctx})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
