"""Plain-JAX layers and parameter init (models/layers.py).

The encoders' parameter trees must keep the names, shapes AND seeded values
of the checkpoints the project has always written, so a seed still gives
the same tower; the pinned sums below were taken from the tree the earlier
Flax linen modules initialized with ``jax.random.key(0)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from patent_tpu.models.layers import (Scope, dense, init_dense, layer_norm,
                                      patch_embed)
from patent_tpu.models.vit import (TEXT_TINY, VIT_B16, VIT_TINY,
                                   TextTransformer, VisionTransformer)

VIT_TINY_SUMS = {
    "['block_0']['attn']['out']['kernel']": 0.398903,
    "['block_0']['attn']['qkv']['kernel']": -13.798126,
    "['block_0']['mlp_in']['kernel']": 22.561791,
    "['block_0']['mlp_out']['kernel']": 12.501146,
    "['block_1']['attn']['out']['kernel']": 7.755346,
    "['block_1']['attn']['qkv']['kernel']": -13.424109,
    "['block_1']['mlp_in']['kernel']": -10.147083,
    "['block_1']['mlp_out']['kernel']": 1.745907,
    "['class_embedding']": 0.246809,
    "['patch_embed']['kernel']": -2.020844,
    "['position_embedding']": -0.041446,
    "['projection']['kernel']": 7.434767,
}
HEAD_SUMS = {"['Dense_0']['kernel']": -6.017276,
             "['Dense_1']['kernel']": 0.62226,
             "['graph_embedding']": 0.241927}


def _random_leaf_sums(tree):
    return {jax.tree_util.keystr(k): float(np.sum(np.asarray(v, np.float64)))
            for k, v in jax.tree_util.tree_leaves_with_path(tree)
            if np.asarray(v).std() > 0}


def test_vit_init_matches_pinned_values():
    params = VisionTransformer(VIT_TINY).init(jax.random.key(0))["params"]
    got = _random_leaf_sums(params)
    assert set(got) == set(VIT_TINY_SUMS)
    for k, want in VIT_TINY_SUMS.items():
        assert got[k] == pytest.approx(want, abs=2e-5), k


def test_text_init_shares_block_values():
    """Same scope paths → same draws: the text tower's blocks equal the
    vision tower's blocks of the same width."""
    t = TextTransformer(TEXT_TINY).init(jax.random.key(0))["params"]
    got = _random_leaf_sums(t)
    for k in ("['block_0']['attn']['qkv']['kernel']",
              "['block_1']['mlp_out']['kernel']"):
        assert got[k] == pytest.approx(VIT_TINY_SUMS[k], abs=2e-5)


def test_alignment_head_init_matches_pinned_values():
    from patent_tpu.train.finetune_clip import AlignmentHead

    head = AlignmentHead(num_nodes=7, graph_dim=16, proj_dim=16,
                         init_tau=0.1)
    p = head.init(jax.random.key(0), jnp.zeros((2, 32)))["params"]
    got = _random_leaf_sums(p)
    for k, want in HEAD_SUMS.items():
        assert got[k] == pytest.approx(want, abs=2e-5), k
    assert float(p["logit_scale"]) == pytest.approx(np.log(10.0))


def test_b16_param_tree_shapes():
    shapes = jax.eval_shape(VisionTransformer(VIT_B16).init,
                            jax.random.key(0))["params"]
    assert shapes["patch_embed"]["kernel"].shape == (16, 16, 3, 768)
    assert shapes["position_embedding"].shape == (197, 768)
    assert shapes["block_11"]["attn"]["qkv"]["kernel"].shape == (768, 2304)
    assert shapes["block_11"]["mlp_in"]["bias"].shape == (3072,)
    assert shapes["projection"]["kernel"].shape == (768, 512)
    assert "bias" not in shapes["projection"]


def test_scope_keys_depend_on_path_and_position():
    root = Scope(jax.random.key(0))
    a = root.child("a").param("w", jax.nn.initializers.normal(1.0), (4,))
    b = root.child("b").param("w", jax.nn.initializers.normal(1.0), (4,))
    s = root.child("c")
    c1 = s.param("w1", jax.nn.initializers.normal(1.0), (4,))
    c2 = s.param("w2", jax.nn.initializers.normal(1.0), (4,))
    vals = [np.asarray(v) for v in (a, b, c1, c2)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.allclose(vals[i], vals[j])
    assert set(root.params) == {"a", "b", "c"}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dense_matches_numpy(rng, dtype):
    root = Scope(jax.random.key(1))
    init_dense(root, "d", 8, 5)
    p = root.params["d"]
    p["bias"] = jnp.asarray(rng.standard_normal(5), jnp.float32)
    x = jnp.asarray(rng.standard_normal((3, 8)), jnp.float32)
    got = dense(p, x, dtype)
    assert got.dtype == jnp.dtype(dtype)
    want = np.asarray(x) @ np.asarray(p["kernel"]) + np.asarray(p["bias"])
    tol = 1e-5 if dtype == jnp.float32 else 5e-2
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=tol, atol=tol)


def test_layer_norm_matches_numpy(rng):
    x = rng.standard_normal((4, 6, 32)).astype(np.float32) * 3 + 1
    p = {"scale": jnp.asarray(rng.random(32), jnp.float32),
         "bias": jnp.asarray(rng.standard_normal(32), jnp.float32)}
    got = np.asarray(layer_norm(p, jnp.asarray(x, jnp.bfloat16)))
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    mu = xb.mean(-1, keepdims=True)
    var = xb.var(-1, keepdims=True)
    want = (xb - mu) / np.sqrt(var + 1e-5) * np.asarray(p["scale"]) \
        + np.asarray(p["bias"])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_patch_embed_matches_im2col(rng):
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    k = rng.standard_normal((8, 8, 3, 5)).astype(np.float32)
    got = np.asarray(patch_embed(jnp.asarray(k), jnp.asarray(x), 8,
                                 jnp.float32))
    patches = x.reshape(2, 2, 8, 2, 8, 3).transpose(0, 1, 3, 2, 4, 5)
    want = patches.reshape(2, 4, 8 * 8 * 3) @ k.reshape(-1, 5)
    assert got.shape == (2, 4, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
