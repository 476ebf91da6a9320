"""Kernel conformance sweep on the card (the JAX package's
tools/conformance.py; reference tests/test-backend-ops.cpp `test` mode):
every plane format through the hand-written qmm kernels in both regimes,
the expert stack and gather, and flash attention on every cache format and
head-dim form, each against a host oracle with the JAX tool's per-case
NMSE bounds.

The oracle is the JAX tool's: a product on the *dequantized* packed bytes,
so a kernel is judged on computing what the bytes hold, not on
quantization error. The port has no encoders, so its packed bytes are
random blocks with sane scales (models/synth.py `random_packed`),
dequantized in f32 by the port's own decoder (models/weights.py
`dense_weight`: the JAX package's codec values), and the activations are
bf16 rounded once. Flash's oracle is the JAX tool's host f32 attention
(`_ref_attention`), with the sinks' and ALiBi's terms where a case has
them.

On the card each case runs through the kernel wrappers (ops/qmatmul.py,
ops/kernels/flash.py) on CUDA tensors, so the hand-written kernels run,
never their plain versions, and a case that launches no kernel fails. On
the CPU (`--device cpu`) the same wrappers take their plain versions. A
case that raises is recorded with its error and counts as failed, as in
the JAX tool; the summary's fields are the JAX tool's, and the exit code
is 1 when any case failed:

    python -m tpullm_torch.tools.conformance [--json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# the JAX tool's bounds: bf16 activations, ~2^-8 relative rounding a
# product, mostly cancelling over K; flash's softmax in f32, its P·V
# accumulated from bf16; the q8 cache adds its quantization to the oracle's
# inputs
QMM_NMSE_BOUND = 5e-4
FLASH_NMSE_BOUND = 2e-3
FLASH_Q8_NMSE_BOUND = 5e-3

QMM_ROWS = (1, 9, 16, 128)  # the gemv body below 16 rows, the tensor cores from 16
MOE_TYPES = ("Q4_K", "Q6_K", "Q8_0", "Q5_K", "Q4_0", "MXFP4")  # the JAX tool's
FLASH_FORMATS = ("bf16", "f16", "f32", "q8")
# (H, Hkv, T) of the decode and prefill regimes' cases; the row groups' R
FLASH_REGIMES = (("decode", 8, 2, 1), ("prefill", 8, 2, 128))
ROW_GROUPS = ((48, 128), (71, 64), (80, 128))  # (R, D): StarCoder, Falcon-7B, the most
LATENT_HEADS = {(576, 512): 16, (288, 256): 40}


def _nmse(got: np.ndarray, ref: np.ndarray) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    denom = float(np.mean(ref * ref)) or 1.0
    return float(np.mean((got - ref) ** 2)) / denom


def _launches() -> int:
    """Every launch the port's kernel wrappers have counted."""
    from ..ops.kernels import flash, qmm

    return (sum(qmm.LAUNCHES.values()) + sum(qmm.TC_LAUNCHES.values())
            + sum(qmm.STACK_LAUNCHES.values()) + sum(qmm.GATHER_LAUNCHES.values())
            + sum(qmm.GROUPED_LAUNCHES.values()) + flash.launch_total())


def _case(cases: list, record: dict, bound: float, fn, ref_fn, log) -> None:
    """Runs fn() (→ a torch tensor), holds it against ref_fn() (numpy) and
    appends the case to `cases`: its NMSE and ok, or ok False and its
    error. On the card a case whose call launched no kernel fails."""
    import torch

    try:
        before = _launches()
        t0 = time.perf_counter()
        y = fn()
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
        dt = time.perf_counter() - t0
        if y.is_cuda and _launches() == before:
            raise RuntimeError("no kernel launched on the card")
        got = y.float().cpu().numpy()
        e = _nmse(got, ref_fn())
        ok = bool(np.isfinite(got).all()) and e <= bound
        cases.append({**record, "nmse": round(e, 9), "ok": ok, "t_s": round(dt, 3)})
        if log:
            log(f"{_label(record)} nmse={e:.2e} {'ok' if ok else 'FAIL'}")
    except Exception as exc:  # noqa: BLE001 — recorded, and it fails the sweep
        cases.append({**record, "ok": False, "error": str(exc)[:300]})
        if log:
            log(f"{_label(record)} ERROR {exc}")


def _label(record: dict) -> str:
    return f"{record['kernel']} " + " ".join(f"{k}={v}" for k, v in record.items()
                                             if k != "kernel")


def _packed(rng, gtype, n_out: int, n_in: int, n_stack: int = 1):
    from ..models.synth import random_packed

    return random_packed(rng, gtype, n_stack * n_out * n_in, scale=0.02, words=True)


def _dense(packed, gtype, n_out: int, n_in: int, dev):
    """[n_in, n_out] f32 numpy: the port's decoder of the packed bytes."""
    import torch

    from ..gguf.reader import GGUFTensorInfo
    from ..models.weights import dense_weight

    info = GGUFTensorInfo("w", gtype, (n_in, n_out), 0, packed)
    return dense_weight(info, dev, dtype=torch.float32).cpu().numpy()


def _bf16(rng, shape, dev):
    """A bf16 tensor of N(0, 1) draws on `dev` and its f32 numpy values."""
    import torch

    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    return x.to(dev), x.float().numpy()


def sweep_qmm(dev, m_sizes=QMM_ROWS, n_in: int = 512, n_out: int = 256,
              log=None) -> list[dict]:
    """Every plane format (ops/qmatmul.py _SCHEMA) through qmm at M rows of
    `m_sizes` (the CUDA-core gemv body below 16 rows, the tensor cores from
    16)."""
    from ..models.weights import QuantLinear
    from ..ops import qmatmul
    from ..ops.kernels import qmm

    rng = np.random.default_rng(0)
    cases = []
    for gtype in sorted(qmatmul._SCHEMA, key=int):
        if not qmm.takes(n_in, n_out):
            cases.append({"kernel": "qmm", "type": gtype.name, "status": "unsupported_shape"})
            continue
        packed = _packed(rng, gtype, n_out, n_in)
        w_ref = _dense(packed, gtype, n_out, n_in, dev)
        ql = QuantLinear(gtype, n_out, n_in, qmatmul.repack(packed, gtype, n_out, n_in, dev))
        for m in m_sizes:
            x, xf = _bf16(rng, (m, n_in), dev)
            _case(cases, {"kernel": "qmm", "type": gtype.name, "m": m}, QMM_NMSE_BOUND,
                  lambda: qmatmul.matmul(x, ql), lambda: xf @ w_ref, log)
    return cases


def sweep_qmoe(dev, types=MOE_TYPES, e: int = 4, n_in: int = 512, n_out: int = 256,
               log=None) -> list[dict]:
    """Packed expert stacks (≡ MUL_MAT_ID): the gather (8 rows, each through
    its routed expert) and the all-experts stack (64 rows, tensor cores)."""
    import torch

    from ..gguf.constants import GGMLType
    from ..gguf.reader import GGUFTensorInfo
    from ..models.weights import load_expert_stack
    from ..ops import qmatmul

    rng = np.random.default_rng(2)
    cases = []
    for name in types:
        gtype = GGMLType[name]
        packed = _packed(rng, gtype, n_out, n_in, e)
        per = len(packed) // e
        w_ref = np.stack([_dense(packed[i * per:(i + 1) * per], gtype, n_out, n_in, dev)
                          for i in range(e)])  # [E, n_in, n_out]
        stack = load_expert_stack(GGUFTensorInfo("exps", gtype, (n_in, n_out, e), 0, packed),
                                  dev)
        x, xf = _bf16(rng, (8, n_in), dev)
        ids = rng.integers(0, e, size=8)
        ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
        _case(cases, {"kernel": "qmoe_gather", "type": name}, QMM_NMSE_BOUND,
              lambda: qmatmul.gather_matmul(x, ids_t, stack),
              lambda: np.einsum("tk,tkn->tn", xf, w_ref[ids]), log)
        xs, xsf = _bf16(rng, (64, n_in), dev)
        _case(cases, {"kernel": "qmoe_stack", "type": name}, QMM_NMSE_BOUND,
              lambda: qmatmul.stack_matmul(xs, stack),
              lambda: np.einsum("mk,ekn->emn", xsf, w_ref), log)
    return cases


def _ref_attention(q, k, v, offsets, scale):
    """Host f32 causal attention oracle: q [B,T,H,D], k/v [B,Hkv,S,D]."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = H // Hkv
    out = np.zeros((B, T, H, v.shape[3]), np.float32)
    for b in range(B):
        for h in range(H):
            kk, vv = k[b, h // g], v[b, h // g]  # [S, D]
            logits = (q[b, :, h] @ kk.T) * scale  # [T, S]
            pos = offsets[b] + np.arange(T)[:, None]
            mask = np.arange(S)[None, :] > pos
            logits = np.where(mask, -np.inf, logits)
            w = np.exp(logits - logits.max(-1, keepdims=True))
            w = w / w.sum(-1, keepdims=True)
            out[b, :, h] = w @ vv
    return out


def _ref_biased(q, k, v, offsets, scale, sinks=None, slopes=None):
    """_ref_attention with a sink logit per head in the softmax's
    denominator, or ALiBi's slope · (key slot − query position) added to
    the scores (the JAX tool's oracles of its sinks and ALiBi cases)."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = H // Hkv
    out = np.zeros((B, T, H, v.shape[3]), np.float32)
    kpos = np.arange(S)[None, :]
    for b in range(B):
        qpos = offsets[b] + np.arange(T)[:, None]
        for h in range(H):
            kk, vv = k[b, h // g], v[b, h // g]
            s = (q[b, :, h] @ kk.T) * scale
            if slopes is not None:
                s = s + slopes[h] * (kpos - qpos).astype(np.float32)
            s = np.where(kpos > qpos, -np.inf, s)
            m = s.max(-1, keepdims=True)
            if sinks is not None:
                m = np.maximum(m, sinks[h])
            w = np.exp(s - m)
            den = w.sum(-1, keepdims=True)
            if sinks is not None:
                den = den + np.exp(sinks[h] - m)
            out[b, :, h] = (w / den) @ vv
    return out


def _kv(rng, fmt: str, shape, dev):
    """K (or V) of `shape` in cache format `fmt`: (the kernel's tensors,
    their f32 numpy values). q8 is the JAX tool's per-row symmetric int8
    (the QuantKVCache layout): (codes, f32 scales)."""
    import torch

    a = rng.standard_normal(shape).astype(np.float32)
    if fmt == "q8":
        s = np.abs(a).max(-1) / 127.0 + 1e-12
        c = np.clip(np.round(a / s[..., None]), -127, 127).astype(np.int8)
        return ((torch.from_numpy(c).to(dev), torch.from_numpy(s.astype(np.float32)).to(dev)),
                c.astype(np.float32) * s[..., None])
    dt = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[fmt]
    t = torch.from_numpy(a).to(dt)
    return t.to(dev), t.float().numpy()


def _flash_call(q, k, v, offsets, scale, **kw):
    from ..ops.kernels import flash

    if isinstance(k, tuple):  # q8: (codes, scales)
        return flash.flash_attention_q8(q, k[0], k[1], v[0], v[1], offsets, scale, **kw)
    return flash.flash_attention(q, k, v, offsets, scale, **kw)


def _flash_case(cases, rng, dev, fmt, record, *, B, T, H, Hkv, D, Dv, S, offsets,
                log, sinks=None, slopes=None):
    import torch

    q, qf = _bf16(rng, (B, T, H, D), dev)
    k, kf = _kv(rng, fmt, (B, Hkv, S, D), dev)
    v, vf = _kv(rng, fmt, (B, Hkv, S, Dv), dev)
    off = np.asarray(offsets, np.int32)
    off_t = torch.from_numpy(off).to(dev)
    scale = 1.0 / np.sqrt(D)
    kw = {}
    if sinks is not None:
        kw["sinks"] = torch.from_numpy(sinks).to(dev)
    if slopes is not None:
        kw["alibi_slopes"] = torch.from_numpy(slopes).to(dev)
    if sinks is None and slopes is None:
        ref = lambda: _ref_attention(qf, kf, vf, off, scale)  # noqa: E731
    else:
        ref = lambda: _ref_biased(qf, kf, vf, off, scale, sinks, slopes)  # noqa: E731
    bound = FLASH_Q8_NMSE_BOUND if fmt == "q8" else FLASH_NMSE_BOUND
    _case(cases, {"kernel": "flash_q8" if fmt == "q8" else "flash", **record}, bound,
          lambda: _flash_call(q, k, v, off_t, scale, **kw), ref, log)


def sweep_flash(dev, S: int = 512, log=None) -> list[dict]:
    """Flash on every cache format at every head-dim form the kernels take
    (ops/kernels/flash.py _HEAD_DIMS, DKDV_DIMS), in the decode regime (T =
    1, 8 heads on 2) and the prefill regime (T = 128); the decode regime's
    row groups at ROW_GROUPS (T = 1, R heads on one KV head, kv 3001); the
    latent forms; the JAX tool's sinks and ALiBi cases (T = 8, D = 128),
    and ALiBi at D = 128 in the decode regime at R = 1 (8 heads on 8) at kv
    3001 (many splits)."""
    import torch

    from ..ops.attention import alibi_slopes
    from ..ops.kernels import flash

    rng = np.random.default_rng(1)
    cases = []
    dims = [(d, d) for d in flash._HEAD_DIMS] + list(flash.DKDV_DIMS)
    for fmt in FLASH_FORMATS:
        for d, dv in dims:
            for label, H, Hkv, T in FLASH_REGIMES:
                _flash_case(cases, rng, dev, fmt, {"case": label, "format": fmt, "d": d,
                                                   "dv": dv},
                            B=1, T=T, H=H, Hkv=Hkv, D=d, Dv=dv, S=S, offsets=[S - T], log=log)
    for R, d in ROW_GROUPS:
        for fmt in ("bf16", "q8"):
            _flash_case(cases, rng, dev, fmt, {"case": "row_groups", "format": fmt, "d": d,
                                               "rows": R},
                        B=1, T=1, H=R, Hkv=1, D=d, Dv=d, S=4096, offsets=[3000], log=log)
    for (d, dv), H in LATENT_HEADS.items():
        for label, T in (("decode", 1), ("prefill", 128)):
            q, qf = _bf16(rng, (1, T, H, d), dev)
            c, cf = _bf16(rng, (1, 1, S, d), dev)
            off = np.asarray([S - T], np.int32)
            off_t = torch.from_numpy(off).to(dev)
            scale = 1.0 / np.sqrt(d)
            _case(cases, {"kernel": "flash", "case": f"latent_{label}", "format": "bf16",
                          "d": d, "dv": dv}, FLASH_NMSE_BOUND,
                  lambda: flash.flash_attention(q, c, c[..., :dv], off_t, scale),
                  lambda: _ref_attention(qf, cf, cf[..., :dv], off, scale), log)
    H, Hkv, D, T = 8, 2, 128, 8
    sinks = rng.standard_normal(H).astype(np.float32)
    for case, kw in (("sinks", {"sinks": sinks}),
                     ("alibi", {"slopes": (0.5 ** np.arange(1, H + 1)).astype(np.float32)})):
        _flash_case(cases, rng, dev, "bf16", {"case": case, "format": "bf16", "d": D},
                    B=1, T=T, H=H, Hkv=Hkv, D=D, Dv=D, S=S, offsets=[S - T], log=log, **kw)
    slopes = alibi_slopes(8, 8.0).numpy()
    for fmt in FLASH_FORMATS:
        _flash_case(cases, rng, dev, fmt, {"case": "alibi_decode", "format": fmt, "d": 128,
                                           "kv": 3001},
                    B=1, T=1, H=8, Hkv=8, D=128, Dv=128, S=4096, offsets=[3000], log=log,
                    slopes=slopes)
    return cases


def summarize(cases: list, t0: float | None = None) -> dict:
    """Summary dict over (possibly partial) sweep cases, the JAX tool's
    fields: the cases that ran, passed and failed (a failed case's whole
    record), the skipped types, the worst qmm and flash NMSE, and the
    seconds since `t0`."""
    ran = [c for c in cases if "ok" in c]
    failed = [c for c in ran if not c["ok"]]
    return {
        "cases": len(ran),
        "passed": len(ran) - len(failed),
        "failed": failed,
        "skipped": [c["type"] for c in cases if "ok" not in c],
        "max_nmse_qmm": max((c["nmse"] for c in ran
                             if c["kernel"] == "qmm" and "nmse" in c),
                            default=None),
        "max_nmse_flash": max((c["nmse"] for c in ran
                               if c["kernel"].startswith("flash")
                               and "nmse" in c),
                              default=None),
        "t_s": round(time.perf_counter() - t0, 1) if t0 else None,
    }


def run_sweep(log=None, device=None) -> dict:
    """The whole sweep on `device` (None: the card); its summary."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    t0 = time.perf_counter()
    cases = []
    with torch.inference_mode():
        for fn in (sweep_qmm, sweep_qmoe, sweep_flash):
            try:
                cases += fn(dev, log=log)
            except Exception as exc:  # noqa: BLE001 — recorded, and it fails the sweep
                cases.append({"kernel": fn.__name__, "ok": False, "error": str(exc)[:300]})
                if log:
                    log(f"{fn.__name__} ERROR {exc}")
    return summarize(cases, t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpullm_torch.tools.conformance")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..ops.kernels import _build

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        _build.build()  # every library at once, before the first case
    log = None if args.json else (lambda m: print(m, file=sys.stderr, flush=True))
    out = run_sweep(log=log, device=dev)
    print(json.dumps(out))
    return 1 if out["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
