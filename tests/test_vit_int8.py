"""Int8 PTQ ViT tests: quantization fidelity + converter structure."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from patent_tpu.models.vit import VIT_TINY, VisionTransformer
from patent_tpu.models.vit_int8 import Int8VisionTransformer, quantize_vit_params
from patent_tpu.ops.quant_matmul import quant_dense, quantize_weight


def test_quantize_weight_roundtrip(rng):
    w = jnp.asarray(rng.standard_normal((64, 32)), jnp.float32)
    q, scale = quantize_weight(w)
    assert q.dtype == jnp.int8
    assert scale.shape == (32,)
    recon = np.asarray(q, np.float32) * np.asarray(scale)
    err = np.abs(recon - np.asarray(w))
    # per-channel symmetric int8: error ≤ half a quantization step
    step = np.asarray(scale)
    assert np.all(err <= step * 0.5 + 1e-6)


def test_int8_dense_matches_f32(rng):
    x = jnp.asarray(rng.standard_normal((8, 64)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((64, 32)) * 0.1, jnp.float32)
    b = jnp.asarray(rng.standard_normal(32) * 0.01, jnp.float32)
    wq, ws = quantize_weight(w)
    got = quant_dense(x, wq, ws, b)
    want = x @ w + b
    rel = np.abs(np.asarray(got) - np.asarray(want)) / (
        np.abs(np.asarray(want)) + 1e-2)
    assert float(np.mean(rel)) < 0.05


def test_int8_vit_feature_fidelity(rng):
    m = VisionTransformer(VIT_TINY, dtype=jnp.float32)
    x = jnp.asarray(rng.random((4, 32, 32, 3)), jnp.float32)
    params = m.init(jax.random.key(0), x)["params"]
    y32 = m.apply({"params": params}, x)
    qp = quantize_vit_params(params)
    mq = Int8VisionTransformer(VIT_TINY, dtype=jnp.float32)
    yq = mq.apply({"params": qp}, x)
    cos = np.sum(np.asarray(y32) * np.asarray(yq), -1) / (
        np.linalg.norm(y32, axis=-1) * np.linalg.norm(yq, axis=-1))
    assert float(cos.min()) > 0.999, f"int8 fidelity too low: {cos}"


def test_int8_preserves_retrieval_ranking(rng):
    """Quantization must not change nearest neighbors for clustered inputs
    (uniformly random images give near-tie similarities where any 1e-3
    perturbation legally reorders; clusters are the retrieval regime)."""
    m = VisionTransformer(VIT_TINY, dtype=jnp.float32)
    bases = rng.random((4, 32, 32, 3))
    x = jnp.asarray(np.concatenate([
        np.clip(bases + rng.normal(0, 0.05, (4,) + bases.shape[1:]) * 0 +
                rng.normal(0, 0.05, bases.shape), 0, 1)
        for _ in range(4)]), jnp.float32)       # 16 images, 4 clusters
    params = m.init(jax.random.key(0), x)["params"]
    y32 = np.asarray(m.apply({"params": params}, x))
    qp = quantize_vit_params(params)
    mq = Int8VisionTransformer(VIT_TINY, dtype=jnp.float32)
    yq = np.asarray(mq.apply({"params": qp}, x))

    def top1(y):
        yn = y / np.linalg.norm(y, axis=-1, keepdims=True)
        sim = yn @ yn.T
        np.fill_diagonal(sim, -np.inf)
        return np.argmax(sim, axis=1)

    # retrieval invariant: the nearest neighbor stays within the query's
    # cluster for both models (exact top-1 among 3 near-identical cluster
    # mates is a legitimate tie — set membership is what retrieval needs)
    cluster = np.arange(16) % 4
    assert (cluster[top1(y32)] == cluster).mean() == 1.0
    assert (cluster[top1(yq)] == cluster).mean() == 1.0
