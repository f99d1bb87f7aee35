"""Geometry core unit tests: closed-form identities + float64 numpy oracle.

The oracle re-implements the geoopt stereographic formulas independently in
numpy float64 (NOT imported from the reference) so that the f32 JAX ops can
be checked for numerical parity — the reference silently runs float64
(src/models.py:248-249), so drift here would silently change recall.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from patent_tpu.ops import (
    PoincareBall,
    dist,
    dist0,
    expmap,
    expmap0,
    gyration,
    insideness,
    disjointedness,
    insideness_unit,
    logmap0,
    mobius_add,
    mobius_fn_apply,
    mobius_matvec,
    pairwise_dist,
    project,
    ptransp,
)


# ----------------------------------------------------------------- oracle ---

def np_mobius_add(x, y, c):
    x2 = np.sum(x * x, -1, keepdims=True)
    y2 = np.sum(y * y, -1, keepdims=True)
    xy = np.sum(x * y, -1, keepdims=True)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    den = 1 + 2 * c * xy + c ** 2 * x2 * y2
    return num / den


def np_dist(x, y, c):
    sc = np.sqrt(c)
    n = np.linalg.norm(np_mobius_add(-x, y, c), axis=-1)
    return 2 / sc * np.arctanh(np.clip(sc * n, 0, 1 - 1e-15))


def np_expmap0(u, c):
    sc = np.sqrt(c)
    n = np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-15)
    return np.tanh(sc * n) * u / (sc * n)


def rand_ball(rng, n, d, c=1.0, scale=0.7):
    """Random points strictly inside the ball of radius 1/sqrt(c)."""
    v = rng.standard_normal((n, d))
    r = rng.uniform(0.05, scale, (n, 1)) / np.sqrt(c)
    return v / np.linalg.norm(v, axis=-1, keepdims=True) * r


# ------------------------------------------------------------------ tests ---

@pytest.mark.parametrize("c", [1.0, 2.0, 0.5])
def test_mobius_add_matches_oracle(rng, c):
    x = rand_ball(rng, 32, 16, c)
    y = rand_ball(rng, 32, 16, c)
    got = mobius_add(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32), c)
    want = np_mobius_add(x, y, c)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("c", [1.0, 2.0])
def test_dist_matches_oracle(rng, c):
    x = rand_ball(rng, 64, 8, c)
    y = rand_ball(rng, 64, 8, c)
    got = dist(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32), c)
    want = np_dist(x, y, c)
    np.testing.assert_allclose(np.asarray(got), want, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("c", [1.0, 2.0])
def test_pairwise_dist_equals_elementwise(rng, c):
    """arcosh closed form == mobius_add/artanh form (mathematical identity)."""
    x = rand_ball(rng, 20, 12, c)
    y = rand_ball(rng, 30, 12, c)
    pm = pairwise_dist(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32), c)
    want = np_dist(x[:, None, :], y[None, :, :], c)
    # f32 Gram-matrix cancellation costs ~5e-3 worst-case on distances O(1-3):
    # irrelevant for ranking, checked tighter in f64 below.
    np.testing.assert_allclose(np.asarray(pm), want, atol=1e-2, rtol=1e-2)
    # f64 check: the closed forms are mathematically identical
    with jax.enable_x64(True):
        pm64 = pairwise_dist(jnp.asarray(x), jnp.asarray(y), c)
        np.testing.assert_allclose(np.asarray(pm64), want, atol=1e-9, rtol=1e-9)


def test_dist_symmetry_and_identity(rng):
    x = jnp.asarray(rand_ball(rng, 16, 8), jnp.float32)
    y = jnp.asarray(rand_ball(rng, 16, 8), jnp.float32)
    np.testing.assert_allclose(dist(x, y, 1.0), dist(y, x, 1.0), atol=1e-5)
    # d(x, x) ≈ 0
    assert float(jnp.max(dist(x, x, 1.0))) < 1e-3


def test_triangle_inequality(rng):
    x, y, z = (jnp.asarray(rand_ball(rng, 64, 8), jnp.float32) for _ in range(3))
    dxz = np.asarray(dist(x, z, 1.0))
    dxy = np.asarray(dist(x, y, 1.0))
    dyz = np.asarray(dist(y, z, 1.0))
    assert np.all(dxz <= dxy + dyz + 1e-4)


@pytest.mark.parametrize("c", [1.0, 2.0])
def test_expmap0_logmap0_roundtrip(rng, c):
    u = jnp.asarray(rng.standard_normal((32, 8)) * 0.5, jnp.float32)
    x = expmap0(u, c)
    # f32 tanh↔artanh roundtrip loses ~1e-3 near saturation; fine for training.
    np.testing.assert_allclose(np.asarray(logmap0(x, c)), np.asarray(u),
                               atol=5e-3, rtol=5e-3)
    # expmap0 matches the oracle
    np.testing.assert_allclose(np.asarray(x), np_expmap0(np.asarray(u, np.float64), c),
                               atol=1e-5, rtol=1e-4)


def test_dist0_consistent_with_dist(rng):
    x = jnp.asarray(rand_ball(rng, 16, 8), jnp.float32)
    np.testing.assert_allclose(np.asarray(dist0(x, 1.0)),
                               np.asarray(dist(x, jnp.zeros_like(x), 1.0)),
                               atol=1e-4)


def test_project_keeps_interior_points(rng):
    x = jnp.asarray(rand_ball(rng, 16, 8, scale=0.5), jnp.float32)
    np.testing.assert_allclose(np.asarray(project(x, 1.0)), np.asarray(x))
    # points outside get clipped inside
    far = jnp.asarray(rng.standard_normal((16, 8)) * 10, jnp.float32)
    norms = jnp.linalg.norm(project(far, 1.0), axis=-1)
    assert float(jnp.max(norms)) < 1.0


@pytest.mark.parametrize("c", [1.0, 2.0])
def test_mobius_matvec_matches_tangent_form(rng, c):
    """M ⊗ x == expmap0(logmap0(x) @ M.T) — the defining property."""
    x = jnp.asarray(rand_ball(rng, 8, 6, c), jnp.float32)
    m = jnp.asarray(rng.standard_normal((4, 6)) * 0.3, jnp.float32)
    got = mobius_matvec(m, x, c)
    want = expmap0(logmap0(x, c) @ m.T, c)
    # identical up to f32 rounding (small components dominate relative error)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-3, rtol=0)


def test_mobius_fn_apply_identity(rng):
    x = jnp.asarray(rand_ball(rng, 8, 6), jnp.float32)
    got = mobius_fn_apply(lambda t: t, x, 1.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(x), atol=1e-4)


def test_expmap_at_x_consistent_with_dist(rng):
    """‖u‖-scaled geodesic: d(x, exp_x(u)) == ‖u‖_x (Riemannian norm)."""
    c = 1.0
    x = jnp.asarray(rand_ball(rng, 16, 8, scale=0.4), jnp.float32)
    u = jnp.asarray(rng.standard_normal((16, 8)) * 0.05, jnp.float32)
    y = expmap(x, u, c)
    from patent_tpu.ops import lambda_x as lam
    riem_norm = np.asarray(lam(x, c) * jnp.linalg.norm(u, axis=-1, keepdims=True))[:, 0]
    np.testing.assert_allclose(np.asarray(dist(x, y, c)), riem_norm, atol=1e-3, rtol=1e-3)


def test_gyration_preserves_norm(rng):
    """Gyrations are isometries of the tangent space: ‖gyr[u,v]w‖ = ‖w‖."""
    u = jnp.asarray(rand_ball(rng, 16, 8, scale=0.5), jnp.float32)
    v = jnp.asarray(rand_ball(rng, 16, 8, scale=0.5), jnp.float32)
    w = jnp.asarray(rng.standard_normal((16, 8)), jnp.float32)
    gw = gyration(u, v, w, 1.0)
    np.testing.assert_allclose(np.asarray(jnp.linalg.norm(gw, axis=-1)),
                               np.asarray(jnp.linalg.norm(w, axis=-1)),
                               rtol=1e-3)


def test_gyration_matches_composition_definition(rng):
    """The closed form equals gyr[u,v]w = ⊖(u⊕v) ⊕ (u ⊕ (v ⊕ w)) — the
    defining identity.  (Norm preservation alone is NOT sufficient: a
    sign-flipped variant is also an isometry and shipped in round 1.)"""
    for c in (1.0, 2.0):
        u = jnp.asarray(rand_ball(rng, 16, 8, scale=0.5) / np.sqrt(c),
                        jnp.float32)
        v = jnp.asarray(rand_ball(rng, 16, 8, scale=0.5) / np.sqrt(c),
                        jnp.float32)
        w = jnp.asarray(rand_ball(rng, 16, 8, scale=0.5) / np.sqrt(c),
                        jnp.float32)
        want = mobius_add(-mobius_add(u, v, c),
                          mobius_add(u, mobius_add(v, w, c), c), c)
        np.testing.assert_allclose(np.asarray(gyration(u, v, w, c)),
                                   np.asarray(want), atol=1e-5, rtol=1e-4)


def test_ptransp_roundtrip(rng):
    """Transport x→y then y→x recovers the vector."""
    x = jnp.asarray(rand_ball(rng, 16, 8, scale=0.5), jnp.float32)
    y = jnp.asarray(rand_ball(rng, 16, 8, scale=0.5), jnp.float32)
    v = jnp.asarray(rng.standard_normal((16, 8)) * 0.1, jnp.float32)
    back = ptransp(y, x, ptransp(x, y, v, 1.0), 1.0)
    np.testing.assert_allclose(np.asarray(back), np.asarray(v), atol=1e-4, rtol=1e-3)


# ------------------------------------------------------------- horosphere ---

def test_insideness_sign_for_nested_points():
    """A point deeper along the same ray is 'inside' its parent's sphere."""
    parent = jnp.asarray([[0.3, 0.0]], jnp.float32)
    child = jnp.asarray([[0.8, 0.0]], jnp.float32)
    # child closer to the boundary ⇒ smaller tangent sphere nested inside
    assert float(insideness(child, parent, 1.0)[0, 0]) > 0
    assert float(insideness(parent, child, 1.0)[0, 0]) < 0


def test_disjointedness_sign_for_opposite_points():
    a = jnp.asarray([[0.9, 0.0]], jnp.float32)
    b = jnp.asarray([[-0.9, 0.0]], jnp.float32)
    assert float(disjointedness(a, b, 1.0)[0, 0]) > 0
    near_a = jnp.asarray([[0.89, 0.01]], jnp.float32)
    assert float(disjointedness(a, near_a, 1.0)[0, 0]) < 0


def test_unit_matches_curvature_corrected_at_c1(rng):
    """At c=1 the two reference formulations agree (models.py:421-441 vs 628-653)."""
    a = jnp.asarray(rand_ball(rng, 16, 4, scale=0.9), jnp.float32)
    b = jnp.asarray(rand_ball(rng, 16, 4, scale=0.9), jnp.float32)
    np.testing.assert_allclose(np.asarray(insideness(a, b, 1.0)),
                               np.asarray(insideness_unit(a, b)),
                               atol=1e-4, rtol=1e-3)


def test_ball_handle(rng):
    ball = PoincareBall(c=2.0)
    x = jnp.asarray(rand_ball(rng, 4, 8, 2.0), jnp.float32)
    y = jnp.asarray(rand_ball(rng, 4, 8, 2.0), jnp.float32)
    np.testing.assert_allclose(np.asarray(ball.dist(x, y)),
                               np.asarray(dist(x, y, 2.0)), atol=1e-6)


def test_jit_and_grad_clean():
    """Ops must be jit-able and produce finite grads near the boundary."""
    @jax.jit
    def loss(x, y):
        return jnp.sum(dist(x, y, 1.0))

    x = jnp.asarray([[0.99, 0.0], [0.1, 0.1]], jnp.float32)
    y = jnp.asarray([[-0.99, 0.0], [0.0, 0.0]], jnp.float32)
    g = jax.grad(loss)(x, y)
    assert np.all(np.isfinite(np.asarray(g)))


def test_euclidean_limit_small_c(rng):
    """As c→0 the ball flattens: d_c(x,y) → 2‖x−y‖ and expmap0 → identity."""
    c = 1e-6
    x = jnp.asarray(rng.standard_normal((16, 8)) * 0.3, jnp.float32)
    y = jnp.asarray(rng.standard_normal((16, 8)) * 0.3, jnp.float32)
    d = np.asarray(dist(x, y, c))
    euclid = 2.0 * np.linalg.norm(np.asarray(x) - np.asarray(y), axis=-1)
    np.testing.assert_allclose(d, euclid, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(expmap0(x, c)), np.asarray(x),
                               rtol=1e-3)
    # mobius_add → ordinary addition
    np.testing.assert_allclose(np.asarray(mobius_add(x, y, c)),
                               np.asarray(x + y), rtol=1e-3, atol=1e-5)


def test_pairwise_small_c_conditioning(rng):
    """The arcosh closed form is ill-conditioned as c→0 in f32 (γ−1 ~ c·‖x−y‖²
    underflows); at c=0.1 — well below any config the framework uses — it
    still tracks the well-conditioned artanh form."""
    c = 0.1
    x = rand_ball(rng, 12, 6, c, scale=0.6)
    pm = np.asarray(pairwise_dist(jnp.asarray(x, jnp.float32),
                                  jnp.asarray(x, jnp.float32), c))
    want = np_dist(x[:, None, :], x[None, :, :], c)
    mask = ~np.eye(len(x), dtype=bool)
    np.testing.assert_allclose(pm[mask], want[mask], rtol=2e-2, atol=1e-3)


def test_dist_monotone_in_curvature(rng):
    """For fixed points inside every ball, distance grows with curvature."""
    x = jnp.asarray([[0.3, 0.1]], jnp.float32)
    y = jnp.asarray([[-0.2, 0.4]], jnp.float32)
    ds = [float(dist(x, y, c)[0]) for c in (0.1, 0.5, 1.0, 2.0)]
    assert ds == sorted(ds)


def test_dist_gradient_finite_at_coincident_points(rng):
    """Backward through d(x, x) must be finite — the figure-pair loss hits
    this exact singular point via self-pairs (f32 NaN regression)."""
    x = jnp.asarray(rand_ball(rng, 8, 16, 2.0, scale=0.69), jnp.float32)

    def loss(a):
        return jnp.sum(dist(a, a, 2.0))        # identically-equal operands

    g = jax.grad(loss)(x)
    assert np.all(np.isfinite(np.asarray(g)))

    def loss2(a, b):
        return jnp.sum(dist(a, b, 2.0))

    g2 = jax.grad(loss2)(x, x + 1e-9)          # near-coincident
    assert np.all(np.isfinite(np.asarray(g2)))
