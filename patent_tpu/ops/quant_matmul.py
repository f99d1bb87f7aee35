"""Dynamic-quantization int8 matmuls in plain XLA.

Weights are quantized symmetrically per output channel once
(``quantize_weight``); activations are quantized per row (token) on the
fly (``_quant_rows``).  The product is an int8 × int8 → int32
``dot_general`` followed by the float32 dequant (row scale · column scale)
and bias.  On a GPU, XLA hands the integer product to cuBLASLt and fuses
the abs-max, round and cast into the producer of the activations.

Two entry points:

* ``quant_dense`` — one dense layer, optional quick-gelu.
* ``quant_mlp``   — a transformer MLP (dense → quick_gelu → dense), float32
  between the two products.

Replaces the serving-side hot loop of the reference's CLIP encode
(`/root/reference/notebooks/retrieval.ipynb` cell 2,
``model.get_image_features`` over the gallery), which the reference runs in
full precision.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quantize_weight(w: jax.Array) -> tuple[jax.Array, jax.Array]:
    """[in, out] float → (int8 weight, [out] f32 scale), symmetric per-channel."""
    w = w.astype(jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(w), axis=0), 1e-8) / 127.0
    q = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


def _quant_rows(xf: jax.Array) -> tuple[jax.Array, jax.Array]:
    """f32 [..., K] → (int8 [..., K], f32 [..., 1] scale); per-row symmetric."""
    amax = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8)
    scale = amax * (1.0 / 127.0)
    q = jnp.round(xf / scale).astype(jnp.int8)
    return q, scale


def _int8_matmul(x: jax.Array, w_i8: jax.Array, w_scale: jax.Array,
                 bias: jax.Array | None) -> jax.Array:
    """float32 ``(quant(x) @ w_i8) · scales + bias`` for x [..., K]."""
    xq, scale = _quant_rows(x.astype(jnp.float32))
    acc = jax.lax.dot_general(
        xq, w_i8, dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    out = acc.astype(jnp.float32) * scale * w_scale
    return out if bias is None else out + bias


def _quick_gelu(g: jax.Array) -> jax.Array:
    return g * jax.nn.sigmoid(1.702 * g)


def quant_dense(x: jax.Array, w_i8: jax.Array, w_scale: jax.Array,
                bias: jax.Array | None = None,
                act: str | None = None) -> jax.Array:
    """``act((quant(x) @ w_i8) · scales + bias)`` with per-row activation
    quantization.

    x: [..., K] (bf16/f32); w_i8: [K, N] int8; w_scale: [N]; bias: [N]|None.
    Returns [..., N] in x.dtype.
    """
    out = _int8_matmul(x, w_i8, w_scale, bias)
    if act == "quick_gelu":
        out = _quick_gelu(out)
    elif act is not None:
        raise ValueError(f"unknown activation {act!r}")
    return out.astype(x.dtype)


def quant_mlp(x: jax.Array, w1_i8: jax.Array, s1: jax.Array, b1: jax.Array,
              w2_i8: jax.Array, s2: jax.Array, b2: jax.Array) -> jax.Array:
    """Transformer MLP ``dense → quick_gelu → dense`` with both products in
    int8; the hidden stays float32 between them.

    x: [..., K]; w1_i8: [K, H] int8; w2_i8: [H, K'] int8; scales/biases per
    output channel.  Returns [..., K'] in x.dtype.
    """
    h = _quick_gelu(_int8_matmul(x, w1_i8, s1, b1))
    return _int8_matmul(h, w2_i8, s2, b2).astype(x.dtype)
