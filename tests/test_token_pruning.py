"""Ink-mass token selection (sparsity-aware serving mode).

Patent drawings are thin dark strokes on blank paper, so most ViT patches
carry no ink.  ``keep_tokens=K`` serves only the K darkest patches (+CLS),
with no new parameters — any trained checkpoint can be served pruned.
These tests pin the selection mechanics; the QUALITY of pruned serving is
measured on the views corpus in tests/test_finetune_lift.py (same trained
tower, full vs pruned battery).
"""

import argparse

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from patent_tpu.models.vit import (VIT_TINY, VisionConfig, VisionTransformer,
                                   _select_tokens, ink_topk_indices)
from patent_tpu.models.vit_int8 import (Int8VisionTransformer,
                                        quantize_vit_params)


def test_ink_topk_picks_darkest_patches():
    """Constructed image: ink drawn in known patches → exactly those
    indices come back, sorted ascending."""
    size, patch = 32, 8                     # 4×4 = 16 patches
    img = np.full((1, size, size, 3), 255.0, np.float32)
    dark = [1, 5, 10, 15]                   # patch grid indices (row-major)
    for p in dark:
        r, c = divmod(p, 4)
        img[0, r * 8:(r + 1) * 8, c * 8:(c + 1) * 8, :] = 0.0
    idx = np.asarray(ink_topk_indices(jnp.asarray(img), patch, 4))
    np.testing.assert_array_equal(idx[0], dark)


def test_ink_topk_ranking_is_scale_invariant():
    """u8-raw, /255 and CLIP-normalized grayscale inputs select the same
    patches (positive per-channel affine invariance for R=G=B images)."""
    rng = np.random.default_rng(0)
    gray = rng.random((2, 32, 32, 1)).astype(np.float32)
    img = np.repeat(gray, 3, axis=3)
    mean = np.asarray([0.481, 0.458, 0.408], np.float32)
    std = np.asarray([0.269, 0.261, 0.276], np.float32)
    a = np.asarray(ink_topk_indices(jnp.asarray(img * 255.0), 8, 6))
    b = np.asarray(ink_topk_indices(jnp.asarray(img), 8, 6))
    c = np.asarray(ink_topk_indices(jnp.asarray((img - mean) / std), 8, 6))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_select_tokens_matches_numpy_reference(rng):
    b, p, d, k = 2, 9, 4, 5
    x = rng.standard_normal((b, p, d)).astype(np.float32)
    pos = rng.standard_normal((p + 1, d)).astype(np.float32)
    cls_row = rng.standard_normal((b, 1, d)).astype(np.float32)
    idx = np.stack([np.sort(rng.choice(p, k, replace=False))
                    for _ in range(b)]).astype(np.int32)
    got = np.asarray(_select_tokens(jnp.asarray(x), jnp.asarray(pos),
                                    jnp.asarray(cls_row), jnp.asarray(idx)))
    want = np.empty((b, k + 1, d), np.float32)
    for i in range(b):
        want[i, 0] = cls_row[i, 0] + pos[0]
        want[i, 1:] = x[i, idx[i]] + pos[idx[i] + 1]
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_keep_all_tokens_is_the_exact_tower(rng):
    """keep_tokens ≥ num_patches must be the identity configuration."""
    imgs = jnp.asarray(rng.random((2, 32, 32, 3)), jnp.float32)
    full = VisionTransformer(VIT_TINY)
    params = jax.jit(full.init)(jax.random.key(0), imgs[:1])
    pruned = VisionTransformer(VIT_TINY, keep_tokens=VIT_TINY.num_patches)
    np.testing.assert_array_equal(np.asarray(full.apply(params, imgs)),
                                  np.asarray(pruned.apply(params, imgs)))


def test_cli_keep_tokens_normalization():
    """--keep-tokens ≤ 0 is rejected; keep ≥ num_patches normalizes to
    None (exact tower) AND writes back to args, so the _kt<K> index tag,
    the model, and the log can never disagree."""
    from patent_tpu.retrieval.cli_actions import _build_encoder

    def ns(keep):
        return argparse.Namespace(keep_tokens=keep, checkpoint=None,
                                  path="/nonexistent", quantize=False)

    with pytest.raises(ValueError, match="positive"):
        _build_encoder(ns(0), 32)
    with pytest.raises(ValueError, match="positive"):
        _build_encoder(ns(-3), 32)
    args = ns(99)                      # 32px/8 config has 16 patches
    _build_encoder(args, 32)
    assert args.keep_tokens is None


def test_pruned_tower_is_trainable(rng):
    """keep_tokens is usable DURING fine-tuning (ClipFinetuneConfig
    .keep_tokens): gradients flow through the gather; the top-k indices
    are data-dependent constants (like maxpool).  Every trainable param
    must receive a finite, not-all-zero gradient."""
    imgs = jnp.asarray(rng.random((4, 32, 32, 3)), jnp.float32)
    model = VisionTransformer(VIT_TINY, keep_tokens=8)
    params = jax.jit(model.init)(jax.random.key(0), imgs[:1])["params"]

    def loss(p):
        f = model.apply({"params": p}, imgs)
        return jnp.sum(f * f)

    g = jax.grad(loss)(params)
    leaves = jax.tree_util.tree_leaves_with_path(g)
    assert leaves
    for path, leaf in leaves:
        assert np.isfinite(np.asarray(leaf)).all(), path
    nonzero = sum(float(np.abs(np.asarray(l)).sum()) > 0
                  for _, l in leaves)
    # everything except the never-gathered pos rows' slices participates;
    # demand the vast majority of leaves carry signal
    assert nonzero >= len(leaves) - 1


def test_pruned_tower_runs_and_int8_matches_bf16(rng):
    """Pruned bf16 and pruned int8 towers agree (the int8 fidelity
    contract holds under pruning too) and produce finite features."""
    cfg = VisionConfig(image_size=32, patch_size=8, hidden_dim=64,
                       num_layers=2, num_heads=4, mlp_dim=128,
                       projection_dim=32)
    keep = 8                                       # of 16 patches
    imgs = jnp.asarray(
        np.where(rng.random((4, 32, 32, 3)) < 0.2, 0.0, 1.0), jnp.float32)
    model = VisionTransformer(cfg, keep_tokens=keep)
    params = jax.jit(model.init)(jax.random.key(0), imgs[:1])
    feats = np.asarray(model.apply(params, imgs))
    assert feats.shape == (4, 32) and np.isfinite(feats).all()

    m8 = Int8VisionTransformer(cfg, keep_tokens=keep)
    p8 = {"params": quantize_vit_params(params["params"])}
    f8 = np.asarray(m8.apply(p8, imgs))
    cos = np.sum(f8 * feats, 1) / np.maximum(
        np.linalg.norm(f8, axis=1) * np.linalg.norm(feats, axis=1), 1e-9)
    assert cos.min() > 0.98
