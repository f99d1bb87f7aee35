"""Attention (ops/attention.py) against the plain einsum reference, the
choice of implementation, and the towers' CLS-only last layer."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from patent_tpu.ops import attention as attn_mod
from patent_tpu.ops.attention import attention, attention_implementation


def einsum_attention(q, k, v, causal=False):
    """f32 reference: softmax(q kᵀ/√d [+ causal mask]) v, [B, S, H, D]."""
    q, k, v = (jnp.asarray(t, jnp.float32) for t in (q, k, v))
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        n = q.shape[1]
        s = jnp.where(jnp.tril(jnp.ones((n, n), bool)), s, -jnp.inf)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)


def _qkv(rng, b=2, s=13, h=4, d=16, dtype=jnp.float32):
    return tuple(jnp.asarray(rng.standard_normal((b, s, h, d)), dtype)
                 for _ in range(3))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_einsum_reference(rng, dtype, tol, causal):
    q, k, v = _qkv(rng, dtype=dtype)
    got = attention(q, k, v, is_causal=causal)
    assert got.dtype == jnp.dtype(dtype) and got.shape == q.shape
    want = einsum_attention(q, k, v, causal)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want), rtol=tol, atol=tol)


def test_attention_grads_match_einsum_reference(rng):
    q, k, v = _qkv(rng, s=9)
    w = jnp.asarray(rng.standard_normal(q.shape), jnp.float32)

    def loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v) * w)

    got = jax.grad(loss(attention), argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss(einsum_attention), argnums=(0, 1, 2))(q, k, v)
    for g, r in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t,s_len,causal", [(197, 197, False), (1, 197, False),
                                             (13, 13, True), (8, 8, False)])
def test_padded_to_even_matches_reference(rng, t, s_len, causal):
    """The odd-length padding the cuDNN route takes (masked pad keys,
    dropped pad queries) leaves values and gradients unchanged — checked
    here through XLA's implementation of the same call."""
    from patent_tpu.ops.attention import padded_to_even

    q = jnp.asarray(rng.standard_normal((2, t, 4, 16)), jnp.float32)
    k, v = (jnp.asarray(rng.standard_normal((2, s_len, 4, 16)), jnp.float32)
            for _ in range(2))
    got = padded_to_even(q, k, v, causal, "xla")
    assert got.shape == q.shape
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(einsum_attention(q, k, v, causal)),
                               rtol=1e-5, atol=1e-5)
    w = jnp.asarray(rng.standard_normal(q.shape), jnp.float32)
    g1 = jax.grad(lambda q, k, v: jnp.sum(
        padded_to_even(q, k, v, causal, "xla") * w), (0, 1, 2))(q, k, v)
    g2 = jax.grad(lambda q, k, v: jnp.sum(
        einsum_attention(q, k, v, causal) * w), (0, 1, 2))(q, k, v)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_attention_implementation_on_cpu_is_xla():
    assert attention_implementation(jnp.bfloat16, 64) == "xla"
    assert attention_implementation(jnp.float32, 64) == "xla"


@pytest.mark.parametrize("dtype,head_dim,want", [
    (jnp.bfloat16, 64, "cudnn"), (jnp.float16, 128, "cudnn"),
    (jnp.float32, 64, "xla"), (jnp.bfloat16, 256, "xla"),
    (jnp.bfloat16, 60, "xla")])
def test_attention_implementation_on_gpu(monkeypatch, dtype, head_dim, want):
    """On a GPU the choice is explicit: cuDNN for operands it accepts,
    XLA's composition for the rest (never a silent ``None``)."""
    monkeypatch.setattr(attn_mod.jax, "default_backend", lambda: "gpu")
    assert attention_implementation(dtype, head_dim) == want


def _layer_inputs(rng, d=32, mlp=64, heads=4, b=3, s=11):
    from patent_tpu.models.layers import Scope
    from patent_tpu.models.vit import init_block

    scope = Scope(jax.random.key(3))
    init_block(scope, d, mlp)
    blk = jax.tree.map(lambda a: a + 0.02 * jnp.asarray(
        rng.standard_normal(a.shape), a.dtype), scope.params)
    x = jnp.asarray(rng.standard_normal((b, s, d)), jnp.float32)
    return blk, x, heads


@pytest.mark.parametrize("tower", ["f32", "bf16", "int8"])
def test_cls_only_layer_equals_full_layer_row0(rng, tower):
    """The CLS-only last layer is row 0 of the full layer: same math per
    row (per-row LayerNorm and per-row int8 activation quantization)."""
    from patent_tpu.models.vit import (dense_mlp, dense_project,
                                       transformer_layer)
    from patent_tpu.models.vit_int8 import (_int8_mlp, _int8_project,
                                            quantize_vit_params)

    blk, x, heads = _layer_inputs(rng)
    if tower == "int8":
        blk = quantize_vit_params({"block_0": blk})["block_0"]
        dtype, project, mlp = jnp.bfloat16, _int8_project, _int8_mlp
    else:
        dtype = jnp.float32 if tower == "f32" else jnp.bfloat16
        project, mlp = dense_project(dtype), dense_mlp(dtype)
    x = x.astype(dtype)
    layer = functools.partial(transformer_layer, num_heads=heads,
                              dtype=dtype, project=project, mlp=mlp)
    full = np.asarray(layer(blk, x)[:, 0], np.float32)
    cls = np.asarray(layer(blk, x, cls_only=True), np.float32)
    assert cls.shape == (x.shape[0], x.shape[-1])
    tol = 1e-5 if tower == "f32" else 3e-2
    np.testing.assert_allclose(cls, full, rtol=tol, atol=tol)
