"""Int8 post-training-quantized ViT inference path.

Serving-side option new to this framework (the reference serves CLIP in
full precision): the transformer's dense layers run as int8 × int8 → int32
products (``ops/quant_matmul``) with

* per-output-channel symmetric weight scales (static, from the f32 params),
* per-token dynamic activation scales (abs-max / 127, computed on the fly),
* attention on the dequantized q/k/v in float32, through the same
  ``ops.attention`` call as the bf16 tower (bf16 operands here moved the
  golden pipeline's pruned-int8 ranking deltas past their limits).

Patch embedding, LayerNorms, softmax and the final projection stay in
bf16/f32: they are a tiny FLOP fraction and quantizing them costs accuracy.
The layer body is ``models/vit.transformer_layer``, shared with the bf16
tower; the last layer computes only the CLS row.  ``quantize_vit_params``
converts a trained ``VisionTransformer`` param tree; feature fidelity is
validated in tests (cosine > 0.99 vs the f32 model).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from ..ops.quant_matmul import quant_dense, quant_mlp, quantize_weight
from .layers import Scope, init_layer_norm, ones, zeros
from .vit import (VIT_B16, VisionConfig, VisionTransformer, _blocks,
                  embed_tokens, read_out, run_layers, transformer_layer)


def _int8_project(p: dict, name: str, x: jax.Array, cols) -> jax.Array:
    w, s, b = p[f"{name}_w"], p[f"{name}_s"], p[f"{name}_b"]
    if cols is not None:
        w, s, b = w[:, cols], s[cols], b[cols]
    return quant_dense(x, w, s, b)


def _int8_mlp(blk: dict, h: jax.Array) -> jax.Array:
    return quant_mlp(h, blk["mlp_in_w"], blk["mlp_in_s"], blk["mlp_in_b"],
                     blk["mlp_out_w"], blk["mlp_out_s"], blk["mlp_out_b"])


def _init_int8_linear(scope: Scope, name: str, fan_in: int,
                      fan_out: int) -> None:
    scope.param(f"{name}_w", zeros, (fan_in, fan_out), jnp.int8)
    scope.param(f"{name}_s", ones, (fan_out,))
    scope.param(f"{name}_b", zeros, (fan_out,))


@dataclasses.dataclass(frozen=True)
class Int8VisionTransformer:
    """Int8 serving twin of ``VisionTransformer`` (same pytree leaf names for
    the non-quantized pieces, so ``quantize_vit_params`` is a pure re-pack).

    ``keep_tokens``: opt-in ink-mass token selection (models/vit.py
    ``ink_topk_indices``).  Quality is measured, not assumed:
    tests/test_token_pruning.py."""

    config: VisionConfig = VIT_B16
    dtype: Any = jnp.bfloat16
    keep_tokens: int | None = None

    def init(self, rng: jax.Array, pixel_values: jax.Array | None = None
             ) -> dict:
        cfg = self.config
        float_tree = VisionTransformer(cfg).init(rng)["params"]
        params = {k: v for k, v in float_tree.items()
                  if not k.startswith("block_")}
        d = cfg.hidden_dim
        for i in range(cfg.num_layers):
            blk = Scope(rng, (f"block_{i}",))
            init_layer_norm(blk, "ln1", d)
            attn = blk.child("attn")
            _init_int8_linear(attn, "qkv", d, 3 * d)
            _init_int8_linear(attn, "out", d, d)
            init_layer_norm(blk, "ln2", d)
            _init_int8_linear(blk, "mlp_in", d, cfg.mlp_dim)
            _init_int8_linear(blk, "mlp_out", cfg.mlp_dim, d)
            params[f"block_{i}"] = blk.params
        return {"params": params}

    def apply(self, variables: dict, pixel_values: jax.Array) -> jax.Array:
        p = variables["params"]
        x = embed_tokens(p, pixel_values, self.config, self.dtype,
                         self.keep_tokens)
        layer = functools.partial(
            transformer_layer, num_heads=self.config.num_heads,
            dtype=self.dtype, project=_int8_project, mlp=_int8_mlp,
            attn_dtype=jnp.float32)
        x = run_layers(_blocks(p, self.config.num_layers), x, layer,
                       cls_last=True)
        return read_out(p, x)


def quantize_vit_params(params: dict) -> dict:
    """f32/bf16 VisionTransformer params → Int8VisionTransformer params."""
    out: dict[str, Any] = {}
    for name, sub in params.items():
        if not name.startswith("block_"):
            out[name] = sub
            continue
        attn = sub["attn"]
        q = {}
        for key, node in (("qkv", attn["qkv"]), ("out", attn["out"])):
            w, s = quantize_weight(jnp.asarray(node["kernel"], jnp.float32))
            q.update({f"{key}_w": w, f"{key}_s": s,
                      f"{key}_b": jnp.asarray(node["bias"], jnp.float32)})
        block = {"ln1": sub["ln1"], "ln2": sub["ln2"], "attn": q}
        for key in ("mlp_in", "mlp_out"):
            w, s = quantize_weight(jnp.asarray(sub[key]["kernel"],
                                               jnp.float32))
            block.update({f"{key}_w": w, f"{key}_s": s,
                          f"{key}_b": jnp.asarray(sub[key]["bias"],
                                                  jnp.float32)})
        out[name] = block
    return out
