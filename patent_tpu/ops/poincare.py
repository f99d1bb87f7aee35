"""Poincaré-ball (stereographic, negative curvature) geometry core.

Pure-JAX, fully vectorized re-derivation of the hyperbolic operations the
reference delegates to ``geoopt.manifolds.stereographic.math`` (reference:
src/models.py:7, src/train.py:<many pmath.* call sites>).  Everything here
has static shapes, no data-dependent control flow, and batched formulations
that turn the work into matmuls with elementwise tails XLA can fuse.

Conventions
-----------
* Curvature is given as ``c > 0`` (ball of radius ``1/sqrt(c)``); the
  reference stores ``k = -c`` (src/models.py:519) — helpers accept ``c``.
* All ops operate on the last axis and broadcast over leading axes.
* dtype-aware boundary epsilon mirrors geoopt's ``project``: 4e-3 for
  float32, 1e-5 for float64 — the reference silently runs in float64
  (src/models.py:248-249 sets the global default); we run in f32 with
  matched clamping, which unit tests verify against f64 closed forms.

The pairwise distance uses the closed form

    d_c(x, y) = (1/sqrt(c)) * arcosh(1 + 2c‖x−y‖² / ((1−c‖x‖²)(1−c‖y‖²)))

which is mathematically identical to geoopt's
``2/sqrt(c) * artanh(sqrt(c) ‖(−x)⊕y‖)`` form but costs one Gram matrix
plus elementwise tail instead of materializing Möbius additions —
this replaces the reference's O(n²) Python double loops of single-pair
``pmath.dist`` calls (src/train.py:1433-1452, 2312-2320, 1832-1840).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

MIN_NORM = 1e-15  # matches reference src/models.py:15

# geoopt-style dtype-dependent distance to the ball boundary.
_BALL_EPS = {jnp.dtype(jnp.float32): 4e-3, jnp.dtype(jnp.float64): 1e-5}


def ball_eps(dtype) -> float:
    return _BALL_EPS.get(jnp.dtype(dtype), 4e-3)


# ---------------------------------------------------------------------------
# numerics helpers
# ---------------------------------------------------------------------------

def _sq_norm(x: jax.Array, keepdims: bool = True) -> jax.Array:
    return jnp.sum(x * x, axis=-1, keepdims=keepdims)


def _norm(x: jax.Array, keepdims: bool = True) -> jax.Array:
    """Smoothed Euclidean norm along the last axis: sqrt(‖x‖² + MIN_NORM²).

    The smoothing (vs a max-clamp) matters for GRADIENTS at x ≈ 0: the
    max-clamp backward computes v/‖v‖ which is NaN/∞ at the cancellation
    point — observed in practice when the figure-pair loss differentiates
    d(x, x) through mobius_add(−x, x) ≈ 0 (f32, reference-scale run).
    The value perturbation is ≤ MIN_NORM = 1e-15, far below f32 resolution
    for any non-degenerate input."""
    return jnp.sqrt(_sq_norm(x, keepdims) + MIN_NORM * MIN_NORM)


def artanh(x: jax.Array) -> jax.Array:
    # clamp into the open interval like geoopt's Artanh autograd fn
    x = jnp.clip(x, -1.0 + 1e-7, 1.0 - 1e-7)
    return jnp.arctanh(x)


def arcosh(x: jax.Array) -> jax.Array:
    x = jnp.maximum(x, 1.0 + 1e-7)
    return jnp.arccosh(x)


# ---------------------------------------------------------------------------
# manifold ops
# ---------------------------------------------------------------------------

def project(x: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    """Clip points into the open ball of radius ``(1-eps)/sqrt(c)``.

    Mirrors ``pmath.project`` (used at reference src/models.py:317, 504).
    """
    c = jnp.asarray(c, x.dtype)
    norm = _norm(x)
    maxnorm = (1.0 - ball_eps(x.dtype)) / jnp.sqrt(jnp.maximum(c, MIN_NORM))
    cond = norm > maxnorm
    projected = x / norm * maxnorm
    return jnp.where(cond, projected, x)


def lambda_x(x: jax.Array, c: float | jax.Array = 1.0, *, keepdims: bool = True) -> jax.Array:
    """Conformal factor λ_x = 2 / (1 − c‖x‖²)."""
    c = jnp.asarray(c, x.dtype)
    return 2.0 / jnp.maximum(1.0 - c * _sq_norm(x, keepdims), MIN_NORM)


def mobius_add(x: jax.Array, y: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    """Möbius addition x ⊕_c y (reference: pmath.mobius_add at models.py:314)."""
    c = jnp.asarray(c, jnp.result_type(x, y))
    x2 = _sq_norm(x)
    y2 = _sq_norm(y)
    xy = jnp.sum(x * y, axis=-1, keepdims=True)
    num = (1.0 + 2.0 * c * xy + c * y2) * x + (1.0 - c * x2) * y
    denom = 1.0 + 2.0 * c * xy + c * c * x2 * y2
    return num / jnp.maximum(denom, MIN_NORM)


def mobius_neg(x: jax.Array) -> jax.Array:
    return -x


def expmap0(u: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    """Exponential map at the origin (reference: pmath.expmap0, models.py:263, 310, 525)."""
    c = jnp.asarray(c, u.dtype)
    sqrt_c = jnp.sqrt(jnp.maximum(c, MIN_NORM))
    u_norm = _norm(u)
    return jnp.tanh(sqrt_c * u_norm) * u / (sqrt_c * u_norm)


def logmap0(y: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    """Logarithmic map at the origin."""
    c = jnp.asarray(c, y.dtype)
    sqrt_c = jnp.sqrt(jnp.maximum(c, MIN_NORM))
    y_norm = _norm(y)
    return y / y_norm / sqrt_c * artanh(sqrt_c * y_norm)


def expmap(x: jax.Array, u: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    """Exponential map at ``x``: exp_x(u) = x ⊕ tanh(√c λ_x ‖u‖ / 2) u/(√c‖u‖)."""
    c = jnp.asarray(c, x.dtype)
    sqrt_c = jnp.sqrt(jnp.maximum(c, MIN_NORM))
    u_norm = _norm(u)
    second = jnp.tanh(sqrt_c / 2.0 * lambda_x(x, c) * u_norm) * u / (sqrt_c * u_norm)
    return mobius_add(x, second, c)


def dist(x: jax.Array, y: jax.Array, c: float | jax.Array = 1.0, *, keepdims: bool = False) -> jax.Array:
    """Geodesic distance, broadcasting like ``pmath.dist`` (elementwise over leading axes).

    d_c(x,y) = 2/√c · artanh(√c ‖(−x) ⊕ y‖)
    """
    c = jnp.asarray(c, jnp.result_type(x, y))
    sqrt_c = jnp.sqrt(jnp.maximum(c, MIN_NORM))
    diff_norm = _norm(mobius_add(-x, y, c), keepdims=keepdims)
    return 2.0 / sqrt_c * artanh(sqrt_c * diff_norm)


def dist0(x: jax.Array, c: float | jax.Array = 1.0, *, keepdims: bool = False) -> jax.Array:
    """Distance to the origin (reference: ball.dist0 at models.py:612, 620)."""
    c = jnp.asarray(c, x.dtype)
    sqrt_c = jnp.sqrt(jnp.maximum(c, MIN_NORM))
    return 2.0 / sqrt_c * artanh(sqrt_c * _norm(x, keepdims=keepdims))


def pairwise_dist(x: jax.Array, y: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    """All-pairs geodesic distance matrix (one Gram matmul).

    Args:
        x: [n, d] points on the ball.
        y: [m, d] points on the ball.
    Returns:
        [n, m] matrix of d_c(x_i, y_j).

    Uses the arcosh closed form (one Gram matmul + elementwise tail); replaces
    the reference's per-pair Python loops (src/train.py:2312-2320, 1433-1452).

    Conditioning: γ−1 scales with c·‖x−y‖², so for c ≲ 1e-3 in f32 the form
    degrades near coincident points; every shipped config uses c ∈ [0.5, 2]
    (reference models.py:508, train.py:4026) where it is exact to ~5e-3.
    """
    dtype = jnp.result_type(x, y)
    c = jnp.asarray(c, dtype)
    x2 = _sq_norm(x)                      # [n, 1]
    y2 = _sq_norm(y)                      # [m, 1]
    # HIGHEST precision: a reduced-precision product (bf16 passes, or TF32
    # on a GPU) destroys the x²−2xy+y² cancellation near the boundary
    # (1−c‖x‖² is tiny there).
    xy = jnp.dot(x, y.T, precision=jax.lax.Precision.HIGHEST)  # [n, m]
    sq_diff = jnp.maximum(x2 - 2.0 * xy + y2.T, 0.0)
    alpha = jnp.maximum(1.0 - c * x2, MIN_NORM)     # [n, 1]
    beta = jnp.maximum(1.0 - c * y2, MIN_NORM)      # [m, 1]
    gamma = 1.0 + 2.0 * c * sq_diff / (alpha * beta.T)
    return arcosh(gamma) / jnp.sqrt(jnp.maximum(c, MIN_NORM))


def mobius_matvec(m: jax.Array, x: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    """Möbius matrix-vector product: x ↦ M ⊗_c x (reference: pmath.mobius_matvec, models.py:307).

    Args:
        m: [out, in] weight matrix (torch ``nn.Linear`` layout).
        x: [..., in] points on the ball.
    """
    dtype = jnp.result_type(m, x)
    c = jnp.asarray(c, dtype)
    sqrt_c = jnp.sqrt(jnp.maximum(c, MIN_NORM))
    x_norm = _norm(x)
    mx = jnp.dot(x, m.T, precision=jax.lax.Precision.HIGHEST)
    mx_norm = _norm(mx)
    res_c = jnp.tanh(mx_norm / x_norm * artanh(sqrt_c * x_norm)) * mx / (mx_norm * sqrt_c)
    # zero rows of mx map to the origin (geoopt cond handling)
    mx_is_zero = jnp.all(mx == 0, axis=-1, keepdims=True)
    return jnp.where(mx_is_zero, jnp.zeros_like(res_c), res_c)


def mobius_fn_apply(fn: Callable[[jax.Array], jax.Array], x: jax.Array,
                    c: float | jax.Array = 1.0) -> jax.Array:
    """Apply a Euclidean fn in the tangent space at 0 (reference: pmath.mobius_fn_apply, models.py:316, 491)."""
    return project(expmap0(fn(logmap0(x, c)), c), c)


def mobius_scalar_mul(r: float | jax.Array, x: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    c = jnp.asarray(c, x.dtype)
    sqrt_c = jnp.sqrt(jnp.maximum(c, MIN_NORM))
    x_norm = _norm(x)
    return jnp.tanh(r * artanh(sqrt_c * x_norm)) * x / (x_norm * sqrt_c)


# ---------------------------------------------------------------------------
# Riemannian calculus (for the Riemannian Adam optax transform)
# ---------------------------------------------------------------------------

def egrad2rgrad(x: jax.Array, grad: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    """Euclidean → Riemannian gradient: g̃ = g / λ_x²."""
    lam = lambda_x(x, c)
    return grad / jnp.maximum(lam * lam, MIN_NORM)


def gyration(u: jax.Array, v: jax.Array, w: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    """Gyration gyr[u, v]w — closed form (Ungar), as used by geoopt's parallel transport."""
    dtype = jnp.result_type(u, v, w)
    c = jnp.asarray(c, dtype)
    u2 = _sq_norm(u)
    v2 = _sq_norm(v)
    uv = jnp.sum(u * v, axis=-1, keepdims=True)
    uw = jnp.sum(u * w, axis=-1, keepdims=True)
    vw = jnp.sum(v * w, axis=-1, keepdims=True)
    c2 = c * c
    # signs verified against the composition definition
    # gyr[u,v]w = ⊖(u⊕v) ⊕ (u ⊕ (v ⊕ w)) to machine epsilon in f64
    # (tests/test_poincare_torch_oracle.py; round 1 shipped a sign-flipped
    # variant that corrupted parallel transport)
    a = -c2 * uw * v2 + c * vw + 2.0 * c2 * uv * vw
    b = -c2 * vw * u2 - c * uw
    d = 1.0 + 2.0 * c * uv + c2 * u2 * v2
    return w + 2.0 * (a * u + b * v) / jnp.maximum(d, MIN_NORM)


def ptransp(x: jax.Array, y: jax.Array, v: jax.Array, c: float | jax.Array = 1.0) -> jax.Array:
    """Parallel transport of tangent vector ``v`` from ``x`` to ``y``."""
    lam_x = lambda_x(x, c)
    lam_y = lambda_x(y, c)
    return gyration(y, -x, v, c) * (lam_x / lam_y)


def inner(x: jax.Array, u: jax.Array, v: jax.Array | None = None,
          c: float | jax.Array = 1.0, *, keepdims: bool = False) -> jax.Array:
    """Riemannian inner product at ``x``."""
    if v is None:
        v = u
    lam = lambda_x(x, c)
    return lam * lam * jnp.sum(u * v, axis=-1, keepdims=keepdims)


# convenience: a tiny namespace object so models can pass geometry around
class PoincareBall:
    """Lightweight stateless handle bundling curvature with the ops above.

    The reference builds ``geoopt.PoincareBall(c=c)`` objects (src/models.py:258,
    360, 461, 520); this is the jax-side equivalent — a pytree-free constant.
    """

    def __init__(self, c: float = 1.0):
        self.c = float(c)

    # point ops
    def projx(self, x):
        return project(x, self.c)

    def expmap0(self, u):
        return expmap0(u, self.c)

    def logmap0(self, y):
        return logmap0(y, self.c)

    def expmap(self, x, u):
        return expmap(x, u, self.c)

    def dist(self, x, y, *, keepdims=False):
        return dist(x, y, self.c, keepdims=keepdims)

    def dist0(self, x, *, keepdims=False):
        return dist0(x, self.c, keepdims=keepdims)

    def pairwise_dist(self, x, y):
        return pairwise_dist(x, y, self.c)

    def mobius_add(self, x, y):
        return mobius_add(x, y, self.c)

    def mobius_matvec(self, m, x):
        return mobius_matvec(m, x, self.c)

    def mobius_fn_apply(self, fn, x):
        return mobius_fn_apply(fn, x, self.c)

    # tangent ops
    def egrad2rgrad(self, x, g):
        return egrad2rgrad(x, g, self.c)

    def ptransp(self, x, y, v):
        return ptransp(x, y, v, self.c)

    def lambda_x(self, x, *, keepdims=True):
        return lambda_x(x, self.c, keepdims=keepdims)

    def __repr__(self):
        return f"PoincareBall(c={self.c})"
