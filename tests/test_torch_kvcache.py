"""Port parity: the KV caches (tpullm_torch.runtime.kvcache) against the
JAX package's: q8 quantization and the sequence write are bit-equal,
including a prefill bucket that overshoots the cache end."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.runtime import kvcache as jkv

from tpullm_torch.runtime import kvcache


def test_quantize_bit_equal():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 7, 64)) * rng.uniform(0, 4, (2, 3, 7, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector: scale 0, codes 0
    x[1, 2, 3, :4] = [127.5, -127.5, 0.5, 1.5]  # ties round half to even
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q, s = kvcache.QuantKVCache._quantize(xb)
    jq, js = jkv.QuantKVCache._quantize(jnp.asarray(x, jnp.bfloat16))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("S,T,off", [
    (16, 4, 3),    # plain write
    (16, 8, 12),   # bucket overshoots the end: clamp and roll
    (16, 16, 5),   # bucket as wide as the cache
    (16, 1, 15),   # decode step into the last slot
    (16, 4, -1),   # negative offset: no write
    (16, 4, 0),
])
def test_seq_write_bit_equal(S, T, off):
    rng = np.random.default_rng(S + T + off)
    L, B, H, D = 2, 2, 3, 8
    cache = rng.standard_normal((L, B, H, S, D)).astype(np.float32)
    new = rng.standard_normal((B, H, T, D)).astype(np.float32)
    ref = jkv._seq_write(jnp.asarray(cache), jnp.asarray(new), off, seq_axis=2,
                         masked=True, layer=1)
    got = torch.from_numpy(cache.copy())
    kvcache._seq_write(got, torch.from_numpy(new), off, seq_axis=2, layer=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kv_dtype", ["bf16", "q8_0"])
def test_cache_update_matches_jax(kv_dtype):
    from tpullm.models.hparams import HParams as JHParams, RopeParams as JRope

    from tpullm_torch.models.hparams import HParams, RopeParams

    dims = dict(arch="llama", n_vocab=8, n_ctx_train=64, n_embd=64, n_layer=2, n_head=4,
                n_head_kv=2, n_ff=64, head_dim=16, head_dim_v=16, rms_eps=1e-5)
    hp, jhp = HParams(rope=RopeParams(), **dims), JHParams(rope=JRope(), **dims)
    S = 32
    cache = kvcache.make_cache(hp, 1, S, kv_dtype, "cpu")
    jcache = jkv.make_cache(jhp, 1, S, kv_dtype)
    rng = np.random.default_rng(3)
    for off, T in ((0, 16), (13, 1), (14, 32)):  # the last bucket overshoots
        k = rng.standard_normal((1, 2, T, 16)).astype(np.float32)
        v = rng.standard_normal((1, 2, T, 16)).astype(np.float32)
        kb = torch.from_numpy(k).to(torch.bfloat16)
        vb = torch.from_numpy(v).to(torch.bfloat16)
        cache = cache.update(1, kb, vb, off)
        jcache = jcache.update(1, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                               jnp.int32(off))
    if kv_dtype == "q8_0":
        pairs = [(cache.k_q, jcache.k_q), (cache.v_q, jcache.v_q),
                 (cache.k_s, jcache.k_s), (cache.v_s, jcache.v_s)]
    else:
        pairs = [(cache.k.float(), jcache.k.astype(jnp.float32)),
                 (cache.v.float(), jcache.v.astype(jnp.float32))]
    for got, ref in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
