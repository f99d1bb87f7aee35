"""Trainable CLS-only last layer (models/vit.transformer_layer cls_only).

Only row 0 of the last block feeds the projection head, so dropping the
other rows' out-proj/MLP work is gradient-EXACT: the dropped rows'
cotangents are identically zero.  These tests pin that claim — same param
tree, same features, same gradients as the full tower — on the CPU XLA
paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from patent_tpu.models.vit import VIT_TINY, VisionTransformer


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.random((4, 32, 32, 3)), jnp.float32)
    plain = VisionTransformer(VIT_TINY, dtype=jnp.float32)
    cls = VisionTransformer(VIT_TINY, dtype=jnp.float32, cls_last=True)
    params = plain.init(jax.random.key(0), x)["params"]
    return x, plain, cls, params


def test_param_tree_identical(setup):
    x, plain, cls, params = setup
    p2 = cls.init(jax.random.key(0), x)["params"]
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(p2)
    for (k1, a), (k2, b) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(p2)):
        assert k1 == k2 and a.shape == b.shape


def test_forward_parity(setup):
    x, plain, cls, params = setup
    f1 = plain.apply({"params": params}, x)
    f2 = cls.apply({"params": params}, x)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2),
                               rtol=1e-5, atol=1e-5)


def test_grad_parity(setup):
    """The loss gradient w.r.t. EVERY parameter (including the last
    block's, whose non-CLS rows are skipped) matches the full tower's."""
    x, plain, cls, params = setup
    tgt = jnp.asarray(np.random.default_rng(3).random((4, 32)), jnp.float32)

    def loss(model):
        def f(p):
            feats = model.apply({"params": p}, x)
            return jnp.sum(jnp.square(feats - tgt))
        return f

    g1 = jax.grad(loss(plain))(params)
    g2 = jax.grad(loss(cls))(params)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(g1),
            jax.tree_util.tree_leaves_with_path(g2)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-5,
            err_msg=jax.tree_util.keystr(path))


def test_keep_tokens_composes(setup):
    """cls_last composes with ink-mass token pruning (different S)."""
    x, _plain, _cls, params = setup
    pruned = VisionTransformer(VIT_TINY, dtype=jnp.float32, cls_last=True,
                               keep_tokens=9)
    ref = VisionTransformer(VIT_TINY, dtype=jnp.float32, keep_tokens=9)
    f1 = ref.apply({"params": params}, x)
    f2 = pruned.apply({"params": params}, x)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2),
                               rtol=1e-5, atol=1e-5)


def test_bf16_finetune_tower_parity():
    """The production fine-tune tower config (bf16) stays feature-close
    with cls_last on."""
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.random((4, 32, 32, 3)), jnp.float32)
    base = VisionTransformer(VIT_TINY, dtype=jnp.bfloat16)
    cls = VisionTransformer(VIT_TINY, dtype=jnp.bfloat16, cls_last=True)
    params = base.init(jax.random.key(0), x)["params"]
    f1 = np.asarray(base.apply({"params": params}, x), np.float32)
    f2 = np.asarray(cls.apply({"params": params}, x), np.float32)
    denom = np.linalg.norm(f1) + 1e-9
    assert np.linalg.norm(f1 - f2) / denom < 2e-2  # bf16 rounding only
