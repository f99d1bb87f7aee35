"""Int8 dynamic-quantization matmuls (ops/quant_matmul.py) against float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from patent_tpu.ops import quant_matmul as qm


def _weights(rng, k, n, scale=0.1):
    w = jnp.asarray(rng.standard_normal((k, n)) * scale, jnp.float32)
    b = jnp.asarray(rng.standard_normal(n) * 0.01, jnp.float32)
    return w, b


@pytest.mark.parametrize("shape", [(8, 64, 32), (3, 17, 96, 48),
                                   (2, 197, 64, 192)])
def test_quant_dense_approximates_f32_matmul(rng, shape):
    *lead, k, n = shape
    x = jnp.asarray(rng.standard_normal((*lead, k)), jnp.float32)
    w, b = _weights(rng, k, n)
    wq, ws = qm.quantize_weight(w)
    got = np.asarray(qm.quant_dense(x, wq, ws, b))
    want = np.asarray(x @ w + b)
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 0.02


def test_quant_dense_gelu_and_dtype(rng):
    x = jnp.asarray(rng.standard_normal((6, 32)), jnp.bfloat16)
    w, b = _weights(rng, 32, 16)
    wq, ws = qm.quantize_weight(w)
    out = qm.quant_dense(x, wq, ws, b, act="quick_gelu")
    assert out.dtype == jnp.bfloat16
    pre = np.asarray(qm.quant_dense(x.astype(jnp.float32), wq, ws, b))
    want = pre / (1.0 + np.exp(-1.702 * pre))
    np.testing.assert_allclose(np.asarray(out, np.float32), want,
                               rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="unknown activation"):
        qm.quant_dense(x, wq, ws, b, act="relu6")


def test_quant_mlp_approximates_f32(rng):
    x = jnp.asarray(rng.standard_normal((4, 9, 32)), jnp.float32)
    w1, b1 = _weights(rng, 32, 128)
    w2, b2 = _weights(rng, 128, 32)
    q1, s1 = qm.quantize_weight(w1)
    q2, s2 = qm.quantize_weight(w2)
    got = np.asarray(qm.quant_mlp(x, q1, s1, b1, q2, s2, b2))
    h = np.asarray(x @ w1 + b1)
    h = h / (1.0 + np.exp(-1.702 * h))
    want = h @ np.asarray(w2) + np.asarray(b2)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 0.03


def test_quant_dense_rows_and_columns_are_independent(rng):
    """Per-row activation scales: a row's output does not depend on the
    other rows, and a column slice of the weight gives the same columns
    — what the CLS-only last layer relies on to compute only row 0's q."""
    x = jnp.asarray(rng.standard_normal((5, 7, 32)), jnp.float32)
    w, b = _weights(rng, 32, 48)
    wq, ws = qm.quantize_weight(w)
    full = np.asarray(qm.quant_dense(x, wq, ws, b))
    row0 = np.asarray(qm.quant_dense(x[:, :1], wq[:, :16], ws[:16], b[:16]))
    np.testing.assert_array_equal(full[:, :1, :16], row0)


def test_quantize_weight_per_channel_bounds(rng):
    w = jnp.asarray(rng.standard_normal((40, 12)) * 3, jnp.float32)
    q, s = qm.quantize_weight(w)
    assert q.dtype == jnp.int8 and s.shape == (12,)
    assert int(jnp.max(jnp.abs(q.astype(jnp.int32)))) == 127
    recon = np.asarray(q, np.float32) * np.asarray(s)
    assert np.all(np.abs(recon - np.asarray(w)) <= np.asarray(s) * 0.5 + 1e-6)


def test_int8_product_is_an_integer_dot(rng):
    """The activation × weight product is int8 × int8 → int32 in the
    compiled program (the path XLA hands to an integer GEMM)."""
    x = jnp.asarray(rng.standard_normal((4, 32)), jnp.float32)
    wq, ws = qm.quantize_weight(jnp.asarray(rng.standard_normal((32, 8)),
                                            jnp.float32))
    text = jax.jit(qm.quant_dense).lower(x, wq, ws).as_text()
    assert "xi8" in text and "xi32" in text
