"""Plain-JAX parameter scopes and layers shared by the encoders.

The encoders are frozen dataclasses with ``init(rng, *inputs)`` →
``{"params": tree}`` and ``apply(variables, *inputs)``.  Their parameter
trees keep the names, shapes and layouts of the checkpoints this project
has always written (Dense: ``kernel`` [in, out] + ``bias``; LayerNorm:
``scale`` + ``bias``; patch conv ``kernel`` [kh, kw, in, out]), so
``load_hf_clip_params`` and saved checkpoints load unchanged.

Initial values are drawn per parameter from a key folded from the root key,
the parameter's scope path and its 1-based position in that scope, through
the SHA-1 fold that Flax's linen modules use.  A seed therefore gives the
same weights as the linen modules these encoders replaced.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable

import jax
import jax.numpy as jnp

Init = Callable[..., jax.Array]

lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones


def normal(stddev: float) -> Init:
    return jax.nn.initializers.normal(stddev)


def _fold_in_path(rng: jax.Array, data: tuple) -> jax.Array:
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    hash_int = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(rng, jnp.uint32(hash_int))


class Scope:
    """Collects one module's parameters during ``init``."""

    def __init__(self, rng: jax.Array, path: tuple[str, ...] = ()):
        self.rng = rng
        self.path = path
        self.params: dict[str, Any] = {}
        self._count = 0

    def child(self, name: str) -> "Scope":
        scope = Scope(self.rng, self.path + (name,))
        self.params[name] = scope.params
        return scope

    def param(self, name: str, init_fn: Init, shape: tuple[int, ...],
              dtype=jnp.float32) -> jax.Array:
        self._count += 1
        key = _fold_in_path(self.rng, self.path + (self._count,))
        value = init_fn(key, shape, dtype)
        self.params[name] = value
        return value


def init_dense(scope: Scope, name: str, in_features: int, features: int,
               use_bias: bool = True) -> None:
    s = scope.child(name)
    s.param("kernel", lecun_normal, (in_features, features))
    if use_bias:
        s.param("bias", zeros, (features,))


def init_layer_norm(scope: Scope, name: str, dim: int) -> None:
    s = scope.child(name)
    s.param("scale", ones, (dim,))
    s.param("bias", zeros, (dim,))


def dense(p: dict, x: jax.Array, dtype=None) -> jax.Array:
    """``x @ kernel + bias`` with inputs, kernel and bias cast to ``dtype``
    (default: their promoted type) before the product."""
    kernel, bias = p["kernel"], p.get("bias")
    if dtype is None:
        dtype = jnp.result_type(x, kernel, *(() if bias is None else (bias,)))
    y = jax.lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
    if bias is not None:
        y = y + bias.astype(dtype)
    return y


def layer_norm(p: dict, x: jax.Array, eps: float = 1e-5) -> jax.Array:
    """LayerNorm over the last axis with float32 statistics and a float32
    result (mean of squares minus squared mean, clipped at zero)."""
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    mu2 = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    var = jnp.maximum(0.0, mu2 - jnp.square(mu))
    mul = jax.lax.rsqrt(var + eps) * p["scale"].astype(jnp.float32)
    return (x - mu) * mul + p["bias"].astype(jnp.float32)


def patch_embed(kernel: jax.Array, x: jax.Array, patch: int,
                dtype) -> jax.Array:
    """Non-overlapping patch convolution, NHWC → [B, P, D] (no bias)."""
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), kernel.astype(dtype), (patch, patch), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y.reshape(y.shape[0], -1, y.shape[-1])
