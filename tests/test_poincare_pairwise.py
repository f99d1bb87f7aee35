"""All-pairs Poincaré distance and the Möbius dense composition against
float64 numpy oracles (ops/poincare.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from patent_tpu.ops import poincare


def rand_ball(rng, n, d, c=1.0, scale=0.7):
    v = rng.standard_normal((n, d))
    r = rng.uniform(0.05, scale, (n, 1)) / np.sqrt(c)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True) * r).astype(
        np.float32)


def dist_f64(x, y, c):
    x, y = x.astype(np.float64), y.astype(np.float64)
    diff = np.sum((x[:, None, :] - y[None, :, :]) ** 2, axis=-1)
    den = ((1 - c * np.sum(x * x, -1))[:, None]
           * (1 - c * np.sum(y * y, -1))[None, :])
    return np.arccosh(1 + 2 * c * diff / den) / np.sqrt(c)


@pytest.mark.parametrize("c", [1.0, 2.0])
@pytest.mark.parametrize("shape", [(40, 30, 16), (256, 256, 128),
                                   (100, 300, 64)])
def test_pairwise_matches_f64_oracle(rng, c, shape):
    n, m, d = shape
    x, y = rand_ball(rng, n, d, c), rand_ball(rng, m, d, c)
    got = np.asarray(poincare.pairwise_dist(jnp.asarray(x), jnp.asarray(y),
                                            c))
    assert got.shape == (n, m)
    np.testing.assert_allclose(got, dist_f64(x, y, c), atol=2e-3, rtol=2e-3)


def _mobius_add_f64(x, y, c):
    xy = np.sum(x * y, -1, keepdims=True)
    x2 = np.sum(x * x, -1, keepdims=True)
    y2 = np.sum(y * y, -1, keepdims=True)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    return num / (1 + 2 * c * xy + c * c * x2 * y2)


@pytest.mark.parametrize("c", [1.0, 2.0])
def test_mobius_dense_composition_matches_f64(rng, c):
    """expmap0(x W) ⊕ b — the Euclidean-input Möbius dense layer — against
    a float64 oracle."""
    x = (rng.standard_normal((100, 48)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((48, 24)) * 0.2).astype(np.float32)
    b = np.asarray(poincare.expmap0(
        jnp.asarray(rng.standard_normal(24) * 1e-3, jnp.float32), c))
    h = poincare.expmap0(jnp.dot(jnp.asarray(x), jnp.asarray(w),
                                 precision=jax.lax.Precision.HIGHEST), c)
    got = np.asarray(poincare.mobius_add(h, jnp.asarray(b), c))
    u = x.astype(np.float64) @ w.astype(np.float64)
    un = np.linalg.norm(u, axis=-1, keepdims=True)
    h64 = np.tanh(np.sqrt(c) * un) * u / (np.sqrt(c) * un)
    want = _mobius_add_f64(h64, b.astype(np.float64), c)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4)


def test_projected_output_stays_on_ball(rng):
    c = 2.0
    x = jnp.asarray(rng.standard_normal((32, 16)) * 5.0, jnp.float32)
    w = jnp.asarray(rng.standard_normal((16, 8)), jnp.float32)
    h = poincare.expmap0(jnp.dot(x, w, precision=jax.lax.Precision.HIGHEST),
                         c)
    out = poincare.project(poincare.mobius_add(h, jnp.zeros(8), c), c)
    norms = np.linalg.norm(np.asarray(out), axis=-1)
    assert norms.max() <= (1 - 3e-3) / np.sqrt(c) + 1e-5
