"""The port's ``models.layers`` and ``models.attention`` against the JAX
package's on the same seeded inputs, in float32 and bfloat16."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers
from test_torch_harness import inputs, ref_lm, to_numpy

#: float32: the same arithmetic up to the order of a few reductions;
#: bfloat16: one rounding of the output apart at most
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = ("float32", "bfloat16")


def close(port, ref, dtype, what=""):
    np.testing.assert_allclose(to_numpy(port), to_numpy(ref), rtol=TOL[dtype], atol=TOL[dtype], err_msg=what)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_swiglu_rope(dtype):
    r = ref_lm().layers
    rng = np.random.default_rng(1)
    x, xt = inputs(rng, (3, 40, 128), dtype)
    w, wt = inputs(rng, (128,), dtype, 0.1)
    close(layers.rmsnorm(xt, wt + 1, 1e-5), r.rmsnorm(x, w + 1, 1e-5), dtype, "rmsnorm")
    p, pt = {}, {}
    for name, shape in (("w_gate", (128, 256)), ("w_up", (128, 256)), ("w_down", (256, 128))):
        p[name], pt[name] = inputs(rng, shape, dtype, shape[0] ** -0.5)
    close(layers.swiglu(xt, pt), r.swiglu(x, p), dtype, "swiglu")
    q, qt = inputs(rng, (2, 40, 4, 32), dtype)
    pos = np.stack([np.arange(40), np.arange(40) + 17])
    close(layers.rope(qt, torch.from_numpy(pos), 1e4), r.rope(q, pos, 1e4), dtype, "rope")
    close(layers.sinusoidal_positions(64, 48), r.sinusoidal_positions(64, 48), "float32", "sinusoidal")


def test_next_token_loss_and_mask():
    r = ref_lm().layers
    rng = np.random.default_rng(2)
    lg, lgt = inputs(rng, (2, 16, 512), "bfloat16", 3.0)
    labels = rng.integers(0, 512, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.7).astype(np.float32)
    close(layers.next_token_loss(lgt, torch.from_numpy(labels)), r.next_token_loss(lg, labels), "float32")
    close(layers.next_token_loss(lgt, torch.from_numpy(labels), torch.from_numpy(mask)),
          r.next_token_loss(lg, labels, mask), "float32")
    zero = np.zeros_like(mask)  # the denominator's floor of 1
    close(layers.next_token_loss(lgt, torch.from_numpy(labels), torch.from_numpy(zero)),
          r.next_token_loss(lg, labels, zero), "float32")


# (S, H, KV, window, q_chunk, kv_chunk): one chunk, GQA, a sliding window,
# 96 split into 3 x 3 chunks (two skipped above the diagonal), and 100 whose
# divisor chunk for 64 is 50
FLASH = [
    (40, 4, 4, 0, 1024, 1024),
    (40, 8, 2, 0, 1024, 1024),
    (96, 4, 2, 24, 1024, 1024),
    (96, 4, 4, 0, 32, 32),
    (96, 8, 2, 40, 32, 32),
    (100, 4, 2, 0, 64, 64),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,h,kvh,window,qc,kc", FLASH)
def test_flash_attention(s, h, kvh, window, qc, kc, dtype):
    r = ref_lm().attention
    rng = np.random.default_rng(s + h + window)
    q, qt = inputs(rng, (2, s, h, 32), dtype)
    k, kt = inputs(rng, (2, s, kvh, 32), dtype)
    v, vt = inputs(rng, (2, s, kvh, 32), dtype)
    got = attn.flash_attention(qt, kt, vt, causal=True, window=window, q_chunk=qc, kv_chunk=kc)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    close(got, r.flash_attention(q, k, v, causal=True, window=window, q_chunk=qc, kv_chunk=kc), dtype,
          "against the reference's flash_attention")
    close(got, r.reference_attention(q, k, v, causal=True, window=window), dtype,
          "against the reference's reference_attention")
    close(attn.reference_attention(qt, kt, vt, causal=True, window=window),
          r.reference_attention(q, k, v, causal=True, window=window), dtype, "reference_attention")


def test_divisor_chunk_equals_reference():
    r = ref_lm().attention
    for n in (1, 7, 96, 100, 1500, 4096):
        for want in (1, 32, 64, 1024):
            assert attn._divisor_chunk(n, want) == r._divisor_chunk(n, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_and_cache_update_per_lane(dtype, window):
    """A per-lane position vector against the reference called lane by lane
    with its scalar position; a lane past the cache's end writes nothing."""
    import jax.numpy as jnp

    r = ref_lm().attention
    rng = np.random.default_rng(5 + window)
    b, sk = 4, 24
    q, qt = inputs(rng, (b, 1, 8, 32), dtype)
    kc, kct = inputs(rng, (b, sk, 2, 32), dtype)
    vc, vct = inputs(rng, (b, sk, 2, 32), dtype)
    kn, knt = inputs(rng, (b, 1, 2, 32), dtype)
    vn, vnt = inputs(rng, (b, 1, 2, 32), dtype)
    pos = np.array([0, 9, sk - 1, sk + 3], np.int32)
    attn.cache_update(kct, vct, knt, vnt, torch.from_numpy(pos))
    got = attn.decode_attention(qt, kct, vct, torch.from_numpy(pos), window=window)
    for i in range(b):
        rk, rv = r.cache_update(kc[i:i + 1], vc[i:i + 1], kn[i:i + 1], vn[i:i + 1], jnp.int32(pos[i]))
        np.testing.assert_array_equal(to_numpy(kct[i:i + 1]), to_numpy(rk), err_msg=f"k lane {i}")
        np.testing.assert_array_equal(to_numpy(vct[i:i + 1]), to_numpy(rv), err_msg=f"v lane {i}")
        want = r.decode_attention(q[i:i + 1], rk, rv, jnp.int32(pos[i]), window=window)
        close(got[i:i + 1], want, dtype, f"lane {i}")
    # a scalar position: every row at one position, as the reference
    got0 = attn.decode_attention(qt, kct, vct, torch.tensor(9, dtype=torch.int32), window=window)
    close(got0, r.decode_attention(q, jnp.asarray(to_numpy(kct)).astype(q.dtype),
                                   jnp.asarray(to_numpy(vct)).astype(q.dtype), jnp.int32(9), window=window),
          dtype, "scalar pos")
