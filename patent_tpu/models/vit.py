"""CLIP-style ViT image and text encoders in plain JAX.

Replaces the reference's dependency on ``transformers.CLIPModel`` (HF,
PyTorch) for ``get_image_features`` / ``get_text_features``
(retrieval.ipynb cell 2, graph gen cells 12-17, train.py:2459-2464):

* patch embedding as a strided convolution,
* pre-LN transformer blocks with a fused QKV projection and attention
  through ``ops.attention`` (cuDNN's fused kernel on a GPU),
* ``quick_gelu`` activation (CLIP's historical x·σ(1.702x)),
* optional bf16 compute dtype with f32 params and LayerNorm statistics,
* optional ``jax.checkpoint`` rematerialization per block,
* an optional CLS-only last layer (``cls_last``): only the CLS row of the
  last block feeds the projection, so its other rows are skipped.

Weight import: ``load_hf_clip_params`` converts a HF ``CLIPModel`` torch
state dict (from a local checkpoint dir — this environment has no network)
into this module's parameter pytree, so reference-trained checkpoints can be
evaluated for parity.

Partial freezing (the reference unfreezes only the last 9 vision layers,
retrieval.ipynb cell 20 / train.py:2459-2464) is expressed as an optax
label pytree via ``finetune_param_labels``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.attention import attention
from .layers import (Scope, dense, init_dense, init_layer_norm, layer_norm,
                     lecun_normal, normal, patch_embed)


def quick_gelu(x: jax.Array) -> jax.Array:
    return x * jax.nn.sigmoid(1.702 * x)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    projection_dim: int = 512

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    hidden_dim: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    projection_dim: int = 512


# ViT-B/16 (openai/clip-vit-base-patch16) — the reference's backbone
VIT_B16 = VisionConfig()
TEXT_B = TextConfig()

# tiny configs for tests
VIT_TINY = VisionConfig(image_size=32, patch_size=8, hidden_dim=64,
                        num_layers=2, num_heads=4, mlp_dim=128, projection_dim=32)
TEXT_TINY = TextConfig(vocab_size=128, context_length=16, hidden_dim=64,
                       num_layers=2, num_heads=4, mlp_dim=128, projection_dim=32)


# Projection callback of ``transformer_layer``: (attn params, name, x,
# output columns or None) → x @ W[:, cols] + b[cols].
Project = Callable[[dict, str, jax.Array, "slice | None"], jax.Array]


def init_block(scope: Scope, d: int, mlp_dim: int) -> None:
    """One pre-LN layer's parameters (ln1, attn/qkv, attn/out, ln2,
    mlp_in, mlp_out)."""
    init_layer_norm(scope, "ln1", d)
    attn = scope.child("attn")
    init_dense(attn, "qkv", d, 3 * d)
    init_dense(attn, "out", d, d)
    init_layer_norm(scope, "ln2", d)
    init_dense(scope, "mlp_in", d, mlp_dim)
    init_dense(scope, "mlp_out", mlp_dim, d)


def transformer_layer(blk: dict, x: jax.Array, num_heads: int, dtype,
                      project: Project, mlp: Callable[[dict, jax.Array],
                                                      jax.Array], *,
                      cls_only: bool = False,
                      is_causal: bool = False,
                      attn_dtype=None) -> jax.Array:
    """One pre-LN layer ``x + attn(LN1(x))``, then ``+ mlp(LN2(·))``.

    x: [B, S, D].  ``cls_only`` computes only the CLS (row-0) output and
    returns [B, D]: every parameter's gradient is still the full layer's,
    because the skipped rows' cotangents are exactly zero.  LN1 and the
    K/V projections still run over every row.  The bf16 and int8 towers
    share this body and differ only in ``project``, ``mlp`` and
    ``attn_dtype`` (the attention operands' dtype, default ``dtype``)."""
    b, s, d = x.shape
    head_dim = d // num_heads

    def heads(t):
        return t.reshape(b, -1, num_heads, head_dim).astype(
            attn_dtype or dtype)

    h = layer_norm(blk["ln1"], x)
    if cls_only:
        q = project(blk["attn"], "qkv", h[:, :1], slice(0, d))
        kv = project(blk["attn"], "qkv", h, slice(d, 3 * d))
        k, v = jnp.split(kv, 2, axis=-1)
        x = x[:, :1]
    else:
        q, k, v = jnp.split(project(blk["attn"], "qkv", h, None), 3, axis=-1)
    o = attention(heads(q), heads(k), heads(v), is_causal=is_causal)
    o = project(blk["attn"], "out", o.reshape(b, -1, d).astype(dtype), None)
    x = x + o.astype(x.dtype)
    x = x + mlp(blk, layer_norm(blk["ln2"], x)).astype(x.dtype)
    return x[:, 0] if cls_only else x


def dense_project(dtype) -> Project:
    def project(p, name, x, cols):
        w = p[name]
        if cols is not None:
            w = {"kernel": w["kernel"][:, cols], "bias": w["bias"][cols]}
        return dense(w, x, dtype)
    return project


def dense_mlp(dtype) -> Callable[[dict, jax.Array], jax.Array]:
    def mlp(blk, h):
        return dense(blk["mlp_out"], quick_gelu(dense(blk["mlp_in"], h, dtype)),
                     dtype)
    return mlp


def run_layers(blocks: list[dict], x: jax.Array, layer: Callable,
               remat: bool = False, cls_last: bool = False) -> jax.Array:
    """Apply ``layer(blk, x, cls_only)`` over the stack, optionally
    rematerialized per block; the last layer is CLS-only if asked."""
    for i, blk in enumerate(blocks):
        fn = functools.partial(layer, cls_only=cls_last and i == len(blocks) - 1)
        x = (jax.checkpoint(fn) if remat else fn)(blk, x)
    return x


def ink_topk_indices(pixel_values: jax.Array, patch_size: int,
                     keep: int) -> jax.Array:
    """[B, H, W, C] pixels → [B, keep] patch indices of the *darkest*
    patches, sorted ascending (spatial order preserved).

    Patent design figures are thin dark ink on white paper (DeepPatent;
    see data/synthetic.synthetic_drawing_arrays), so a patch's summed
    brightness ranks its information content: blank-paper patches are the
    brightest.  The ranking is invariant to any per-channel positive
    affine rescaling of the pixels for grayscale-consistent images
    (R≈G≈B — true of patent drawings), so raw u8, /255, and
    CLIP-normalized inputs all select the same patches.

    Static shapes: one reshape-sum + ``top_k`` + ``sort`` — jit-friendly,
    no data-dependent control flow.
    """
    b, h, w, c = pixel_values.shape
    gh, gw = h // patch_size, w // patch_size
    x = pixel_values.astype(jnp.float32).reshape(
        b, gh, patch_size, gw, patch_size, c)
    brightness = x.sum(axis=(2, 4, 5)).reshape(b, gh * gw)       # [B, P]
    _, idx = jax.lax.top_k(-brightness, keep)                    # darkest
    return jnp.sort(idx, axis=-1)


def _select_tokens(x: jax.Array, pos: jax.Array, cls_row: jax.Array,
                   idx: jax.Array) -> jax.Array:
    """Gather patch tokens + their position embeddings by ``idx`` and
    prepend CLS (+ its position).  x: [B, P, D]; pos: [P+1, D] (row 0 is
    CLS's); cls_row: [B, 1, D]; idx: [B, K] → [B, K+1, D]."""
    gathered = jnp.take_along_axis(x, idx[..., None], axis=1)
    gpos = jnp.take(pos, idx + 1, axis=0)                 # [B, K, D]
    first = cls_row + pos[jnp.newaxis, :1]
    return jnp.concatenate([first, gathered + gpos], axis=1)


def assemble_token_stream(x: jax.Array, pixel_values: jax.Array, cfg,
                          cls_row: jax.Array, pos: jax.Array,
                          keep_tokens: int | None) -> jax.Array:
    """CLS + positional embedding assembly shared by the bf16 and int8
    towers — ONE copy so the pruning semantics (ink_topk_indices gate,
    keep≥num_patches = exact tower, pos-row offsets) can never
    desynchronize between the serving precisions.

    x: [B, P, D] patch embeddings; pos: [P+1, D]; cls_row: [B, 1, D].
    """
    if keep_tokens is not None and keep_tokens < cfg.num_patches:
        idx = ink_topk_indices(pixel_values, cfg.patch_size, keep_tokens)
        return _select_tokens(x, pos, cls_row, idx)
    return jnp.concatenate([cls_row, x], axis=1) + pos


@dataclasses.dataclass(frozen=True)
class VisionTransformer:
    """CLIP vision tower → projected image features (get_image_features).

    ``init(rng, pixel_values)`` → ``{"params": tree}``;
    ``apply(variables, pixel_values)`` → [B, projection_dim] float32.

    ``cls_last``: compute only the CLS row of the last layer (same
    features, same gradients — the serving and fine-tune default).
    ``keep_tokens``: OPT-IN sparsity-aware mode — keep only the K
    highest-ink patches (ink_topk_indices) plus CLS.  Adds no parameters,
    so any trained checkpoint can be served pruned; quality vs the full
    tower is measured in tests/test_token_pruning.py.  None = exact tower.
    """

    config: VisionConfig = VIT_B16
    dtype: Any = jnp.float32
    remat: bool = False
    cls_last: bool = False
    keep_tokens: int | None = None

    def init(self, rng: jax.Array, pixel_values: jax.Array | None = None
             ) -> dict:
        cfg = self.config
        root = Scope(rng)
        root.child("patch_embed").param(
            "kernel", lecun_normal,
            (cfg.patch_size, cfg.patch_size, 3, cfg.hidden_dim))
        root.param("class_embedding", normal(0.02), (cfg.hidden_dim,))
        root.param("position_embedding", normal(0.01),
                   (cfg.num_patches + 1, cfg.hidden_dim))
        init_layer_norm(root, "pre_ln", cfg.hidden_dim)
        for i in range(cfg.num_layers):
            init_block(root.child(f"block_{i}"), cfg.hidden_dim, cfg.mlp_dim)
        init_layer_norm(root, "post_ln", cfg.hidden_dim)
        init_dense(root, "projection", cfg.hidden_dim, cfg.projection_dim,
                   use_bias=False)
        return {"params": root.params}

    def apply(self, variables: dict, pixel_values: jax.Array) -> jax.Array:
        """pixel_values: [B, H, W, 3] (NHWC, normalized) → [B, proj]."""
        p = variables["params"]
        x = embed_tokens(p, pixel_values, self.config, self.dtype,
                         self.keep_tokens)
        layer = functools.partial(
            transformer_layer, num_heads=self.config.num_heads,
            dtype=self.dtype, project=dense_project(self.dtype),
            mlp=dense_mlp(self.dtype))
        x = run_layers(_blocks(p, self.config.num_layers), x, layer,
                       remat=self.remat, cls_last=self.cls_last)
        return read_out(p, x)


def _blocks(p: dict, num_layers: int) -> list[dict]:
    return [p[f"block_{i}"] for i in range(num_layers)]


def embed_tokens(p: dict, pixel_values: jax.Array, cfg: VisionConfig,
                 dtype, keep_tokens: int | None) -> jax.Array:
    """Patch embedding + CLS + positions + pre-LN → [B, S, D] in ``dtype``
    (shared by the bf16 and int8 towers)."""
    x = patch_embed(p["patch_embed"]["kernel"], pixel_values,
                    cfg.patch_size, dtype)
    b = x.shape[0]
    cls_row = jnp.broadcast_to(p["class_embedding"],
                               (b, 1, cfg.hidden_dim)).astype(dtype)
    x = assemble_token_stream(x, pixel_values, cfg, cls_row,
                              p["position_embedding"].astype(dtype),
                              keep_tokens)
    return layer_norm(p["pre_ln"], x).astype(dtype)


def read_out(p: dict, x: jax.Array) -> jax.Array:
    """CLS row → post-LN → projection, in float32."""
    if x.ndim == 3:
        x = x[:, 0]
    return dense(p["projection"], layer_norm(p["post_ln"], x), jnp.float32)


@dataclasses.dataclass(frozen=True)
class TextTransformer:
    """CLIP text tower → projected text features (get_text_features).

    Used for CPC-definition / patent-title embeddings (graph gen cells 12-15).
    """

    config: TextConfig = TEXT_B
    dtype: Any = jnp.float32

    def init(self, rng: jax.Array, input_ids: jax.Array | None = None
             ) -> dict:
        cfg = self.config
        root = Scope(rng)
        root.param("token_embedding", normal(0.02),
                   (cfg.vocab_size, cfg.hidden_dim))
        root.param("position_embedding", normal(0.01),
                   (cfg.context_length, cfg.hidden_dim))
        for i in range(cfg.num_layers):
            init_block(root.child(f"block_{i}"), cfg.hidden_dim, cfg.mlp_dim)
        init_layer_norm(root, "final_ln", cfg.hidden_dim)
        init_dense(root, "projection", cfg.hidden_dim, cfg.projection_dim,
                   use_bias=False)
        return {"params": root.params}

    def apply(self, variables: dict, input_ids: jax.Array) -> jax.Array:
        """input_ids: [B, L] int tokens (EOS = max id in row) → [B, proj]."""
        cfg = self.config
        p = variables["params"]
        l = input_ids.shape[1]
        x = (p["token_embedding"][input_ids].astype(self.dtype)
             + p["position_embedding"][:l].astype(self.dtype))
        layer = functools.partial(
            transformer_layer, num_heads=cfg.num_heads, dtype=self.dtype,
            project=dense_project(self.dtype), mlp=dense_mlp(self.dtype),
            is_causal=True)
        x = run_layers(_blocks(p, cfg.num_layers), x, layer)
        x = layer_norm(p["final_ln"], x)
        # CLIP pools at the EOS position = argmax of token ids
        eos = jnp.argmax(input_ids, axis=-1)
        pooled = x[jnp.arange(x.shape[0]), eos]
        return dense(p["projection"], pooled, jnp.float32)


# --------------------------------------------------------------------------
# HF CLIP weight import (local checkpoints only — no network in this env)
# --------------------------------------------------------------------------

def load_hf_clip_params(checkpoint_dir: str,
                        vision_config: VisionConfig = VIT_B16) -> dict:
    """Convert a local HF ``CLIPModel`` checkpoint into VisionTransformer params.

    Maps ``vision_model.*`` + ``visual_projection`` tensors; torch Linear
    weights are [out, in] and get transposed to [in, out]; the patch
    conv [out, in, kh, kw] becomes [kh, kw, in, out].

    Executed parity vs torch ``CLIPModel.get_image_features`` is pinned by
    tests/test_clip_parity.py (max-abs ≤ 1e-4 in f32 on a random-init model
    round-tripped through save_pretrained → this loader).
    """
    from transformers import CLIPModel

    model = CLIPModel.from_pretrained(checkpoint_dir)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return hf_clip_vision_params(sd, vision_config)


def load_hf_clip_text_params(checkpoint_dir: str,
                             text_config: TextConfig = TEXT_B) -> dict:
    """Convert a local HF ``CLIPModel`` checkpoint's text tower
    (``text_model.*`` + ``text_projection``) into TextTransformer params."""
    from transformers import CLIPModel

    model = CLIPModel.from_pretrained(checkpoint_dir)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return hf_clip_text_params(sd, text_config)


def hf_clip_vision_params(sd: dict[str, np.ndarray],
                          vision_config: VisionConfig = VIT_B16) -> dict:
    """state-dict (numpy) → VisionTransformer param pytree (see
    load_hf_clip_params; split out so in-process torch models can be
    converted without a save/load round-trip)."""

    def lin(prefix):
        return {"kernel": sd[prefix + ".weight"].T, "bias": sd[prefix + ".bias"]}

    p: dict[str, Any] = {}
    vm = "vision_model"
    p["patch_embed"] = {"kernel": np.transpose(
        sd[f"{vm}.embeddings.patch_embedding.weight"], (2, 3, 1, 0))}
    p["class_embedding"] = sd[f"{vm}.embeddings.class_embedding"]
    p["position_embedding"] = sd[f"{vm}.embeddings.position_embedding.weight"]
    p["pre_ln"] = {"scale": sd[f"{vm}.pre_layrnorm.weight"],
                   "bias": sd[f"{vm}.pre_layrnorm.bias"]}
    for i in range(vision_config.num_layers):
        enc = f"{vm}.encoder.layers.{i}"
        q = lin(f"{enc}.self_attn.q_proj")
        k = lin(f"{enc}.self_attn.k_proj")
        v = lin(f"{enc}.self_attn.v_proj")
        p[f"block_{i}"] = {
            "ln1": {"scale": sd[f"{enc}.layer_norm1.weight"],
                    "bias": sd[f"{enc}.layer_norm1.bias"]},
            "ln2": {"scale": sd[f"{enc}.layer_norm2.weight"],
                    "bias": sd[f"{enc}.layer_norm2.bias"]},
            "attn": {
                "qkv": {"kernel": np.concatenate(
                            [q["kernel"], k["kernel"], v["kernel"]], axis=1),
                        "bias": np.concatenate(
                            [q["bias"], k["bias"], v["bias"]])},
                "out": lin(f"{enc}.self_attn.out_proj"),
            },
            "mlp_in": lin(f"{enc}.mlp.fc1"),
            "mlp_out": lin(f"{enc}.mlp.fc2"),
        }
    p["post_ln"] = {"scale": sd[f"{vm}.post_layernorm.weight"],
                    "bias": sd[f"{vm}.post_layernorm.bias"]}
    p["projection"] = {"kernel": sd["visual_projection.weight"].T}
    return jax.tree.map(jnp.asarray, p)


def fold_u8_normalize_params(params: dict) -> dict:
    """Fold CLIP's ``(x/255 − mean)/std`` input normalization into the
    patch-embed kernel and position embedding, so RAW uint8 pixel batches
    feed the conv directly (the tower's own ``astype`` is the only
    remaining input op).

    The serving wire format is uint8 (4× less host→device transfer,
    ``ImageBatcher(out_dtype="u8")``).  XLA usually fuses the normalize
    pass into the patch conv; this transform exists for contexts where that
    fusion is not guaranteed, and as the algebraic record.  Normalization
    is affine per input channel, and the conv is linear, so it folds
    exactly:

        conv(x·a + b) = conv(x)·a_folded + Σ_{h,w,c} K[h,w,c,:]·b[c]

    with ``a = 1/(255·std)`` scaling the kernel's input-channel slices and
    the per-output-channel constant added to the PATCH rows of the position
    embedding (the CLS row takes no conv output, so it is untouched).

    Works on both ``VisionTransformer`` and ``Int8VisionTransformer`` trees
    (patch embed is unquantized in both).  Returns a NEW tree; the folded
    tree must only see raw-u8-scale inputs.  Matches the behavioral
    contract of ``Normalize(mean, std)`` in the reference's serving loader
    (/root/reference/notebooks/retrieval.ipynb cell 2).
    """
    from ..input.pipeline import CLIP_MEAN, CLIP_STD

    kernel = jnp.asarray(params["patch_embed"]["kernel"], jnp.float32)
    pos = jnp.asarray(params["position_embedding"], jnp.float32)
    a = jnp.asarray(1.0 / (255.0 * CLIP_STD), jnp.float32)        # [3]
    b = jnp.asarray(-CLIP_MEAN / CLIP_STD, jnp.float32)           # [3]
    folded_kernel = kernel * a[None, None, :, None]
    bias = jnp.einsum("hwcd,c->d", kernel, b)                     # [D]
    folded_pos = pos.at[1:].add(bias)
    out = dict(params)
    out["patch_embed"] = {"kernel": folded_kernel.astype(kernel.dtype)}
    out["position_embedding"] = folded_pos.astype(pos.dtype)
    return out


def hf_clip_vision_state_dict(params: dict,
                              vision_config: VisionConfig = VIT_B16
                              ) -> dict[str, np.ndarray]:
    """VisionTransformer param pytree → HF ``CLIPModel`` state-dict entries
    (vision_model.* + visual_projection) — the exact inverse of
    ``hf_clip_vision_params``.

    Closes the checkpoint loop the reference relies on
    (save_pretrained/from_pretrained hand-offs between fine-tuning and
    serving, retrieval.ipynb cells 2/16/20): a tower fine-tuned here can be
    loaded back into ``transformers`` with
    ``model.load_state_dict(sd, strict=False)``.  Round-trip parity is
    executed in tests/test_clip_parity.py.
    """
    p = jax.tree.map(lambda x: np.asarray(x, np.float32), params)

    def lin(prefix, node):
        return {prefix + ".weight": node["kernel"].T,
                prefix + ".bias": node["bias"]}

    vm = "vision_model"
    sd: dict[str, np.ndarray] = {
        f"{vm}.embeddings.patch_embedding.weight": np.transpose(
            p["patch_embed"]["kernel"], (3, 2, 0, 1)),
        f"{vm}.embeddings.class_embedding": p["class_embedding"],
        f"{vm}.embeddings.position_embedding.weight":
            p["position_embedding"],
        f"{vm}.pre_layrnorm.weight": p["pre_ln"]["scale"],
        f"{vm}.pre_layrnorm.bias": p["pre_ln"]["bias"],
        f"{vm}.post_layernorm.weight": p["post_ln"]["scale"],
        f"{vm}.post_layernorm.bias": p["post_ln"]["bias"],
        "visual_projection.weight": p["projection"]["kernel"].T,
    }
    d = vision_config.hidden_dim
    for i in range(vision_config.num_layers):
        enc = f"{vm}.encoder.layers.{i}"
        blk = p[f"block_{i}"]
        sd[f"{enc}.layer_norm1.weight"] = blk["ln1"]["scale"]
        sd[f"{enc}.layer_norm1.bias"] = blk["ln1"]["bias"]
        sd[f"{enc}.layer_norm2.weight"] = blk["ln2"]["scale"]
        sd[f"{enc}.layer_norm2.bias"] = blk["ln2"]["bias"]
        qkv_k = blk["attn"]["qkv"]["kernel"]          # [D, 3D]
        qkv_b = blk["attn"]["qkv"]["bias"]
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[f"{enc}.self_attn.{name}.weight"] = \
                qkv_k[:, j * d:(j + 1) * d].T
            sd[f"{enc}.self_attn.{name}.bias"] = qkv_b[j * d:(j + 1) * d]
        sd.update(lin(f"{enc}.self_attn.out_proj", blk["attn"]["out"]))
        sd.update(lin(f"{enc}.mlp.fc1", blk["mlp_in"]))
        sd.update(lin(f"{enc}.mlp.fc2", blk["mlp_out"]))
    return sd


def hf_clip_text_params(sd: dict[str, np.ndarray],
                        text_config: TextConfig = TEXT_B) -> dict:
    """state-dict (numpy) → TextTransformer param pytree (text_model.* +
    text_projection; same Linear/LN conventions as the vision converter)."""

    def lin(prefix):
        return {"kernel": sd[prefix + ".weight"].T, "bias": sd[prefix + ".bias"]}

    tm = "text_model"
    p: dict[str, Any] = {
        "token_embedding": sd[f"{tm}.embeddings.token_embedding.weight"],
        "position_embedding":
            sd[f"{tm}.embeddings.position_embedding.weight"],
        "final_ln": {"scale": sd[f"{tm}.final_layer_norm.weight"],
                     "bias": sd[f"{tm}.final_layer_norm.bias"]},
        "projection": {"kernel": sd["text_projection.weight"].T},
    }
    for i in range(text_config.num_layers):
        enc = f"{tm}.encoder.layers.{i}"
        q = lin(f"{enc}.self_attn.q_proj")
        k = lin(f"{enc}.self_attn.k_proj")
        v = lin(f"{enc}.self_attn.v_proj")
        p[f"block_{i}"] = {
            "ln1": {"scale": sd[f"{enc}.layer_norm1.weight"],
                    "bias": sd[f"{enc}.layer_norm1.bias"]},
            "ln2": {"scale": sd[f"{enc}.layer_norm2.weight"],
                    "bias": sd[f"{enc}.layer_norm2.bias"]},
            "attn": {
                "qkv": {"kernel": np.concatenate(
                            [q["kernel"], k["kernel"], v["kernel"]], axis=1),
                        "bias": np.concatenate(
                            [q["bias"], k["bias"], v["bias"]])},
                "out": lin(f"{enc}.self_attn.out_proj"),
            },
            "mlp_in": lin(f"{enc}.mlp.fc1"),
            "mlp_out": lin(f"{enc}.mlp.fc2"),
        }
    return jax.tree.map(jnp.asarray, p)


def finetune_param_labels(params: dict, num_trainable_blocks: int = 9,
                          num_layers: int = 12) -> dict:
    """optax.multi_transform labels: 'train' for the last N vision blocks +
    post_ln + projection, 'frozen' otherwise (reference unfreezes the last 9
    vision layers: retrieval.ipynb cell 20, train.py:2459-2464)."""
    import re

    first_trainable = num_layers - num_trainable_blocks

    def label(path, _leaf):
        keystr = jax.tree_util.keystr(path)
        # exact block index (substring matching would classify block_11 by
        # block_1's policy)
        m = re.search(r"block_(\d+)", keystr)
        if m:
            return ("train" if int(m.group(1)) >= first_trainable
                    else "frozen")
        if "post_ln" in keystr or "projection" in keystr:
            return "train"
        return "frozen"

    return jax.tree_util.tree_map_with_path(label, params)
