"""Contrastive losses: hyperbolic InfoNCE, multi-positive NT-Xent, graph NCE.

All are fully vectorized — the reference builds its n×n hyperbolic distance
matrix with a double Python loop of single-pair ``pmath.dist`` calls
(src/train.py:2312-2320, 1832-1840), here it is one ``pairwise_dist`` (a
Gram matmul + elementwise tail).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import poincare


def hyperbolic_info_nce(anchors: jax.Array, positives: jax.Array,
                        c: float = 1.0, temperature: float = 0.07) -> jax.Array:
    """Bidirectional InfoNCE over −pairwise_dist/τ with diagonal targets.

    Matches ``hyperbolic_contrastive_loss`` (src/train.py:2291-2336).
    """
    n = anchors.shape[0]
    sims = -poincare.pairwise_dist(anchors, positives, c) / temperature   # [n, n]
    labels = jnp.arange(n)
    loss_a2p = -jnp.mean(jax.nn.log_softmax(sims, axis=1)[labels, labels])
    loss_p2a = -jnp.mean(jax.nn.log_softmax(sims.T, axis=1)[labels, labels])
    return (loss_a2p + loss_p2a) / 2.0


def multi_positive_nt_xent(features: jax.Array, logit_scale: jax.Array | float,
                           group_labels: jax.Array | None = None) -> jax.Array:
    """Multi-positive NT-Xent over a [2B, D] anchor∥positive feature batch.

    Matches the CLIP fine-tune loss (retrieval.ipynb cell 16/20
    ``MultiPositiveContrastiveLoss``): L2-normalize, scaled similarity
    logits with the diagonal masked to −1e9, soft-target matrix P over
    same-group entries (row-normalized), bidirectional soft cross-entropy.

    Args:
        features: [2B, D] image features, first B anchors then B positives
            (the reference's ``torch.cat([anchors, positives])`` layout).
        logit_scale: scalar 1/τ (cell 20 uses learnable exp(logit_scale)
            clamped to ≤100; pass the already-exp'ed, clamped value).
        group_labels: optional [2B] int labels; default ``arange(2B) % B``
            (pair i with i+B) like the reference.
    """
    n = features.shape[0]
    z = features / jnp.maximum(jnp.linalg.norm(features, axis=1, keepdims=True), 1e-12)
    logits = jnp.dot(z, z.T, precision=jax.lax.Precision.HIGHEST) * logit_scale
    if group_labels is None:
        group_labels = jnp.arange(n) % (n // 2)
    p = (group_labels[:, None] == group_labels[None, :]).astype(z.dtype)
    eye = jnp.eye(n, dtype=bool)
    p = jnp.where(eye, 0.0, p)
    logits = jnp.where(eye, -1e9, logits)
    p = p / jnp.maximum(jnp.sum(p, axis=1, keepdims=True), 1e-8)
    log_q = jax.nn.log_softmax(logits, axis=1)
    # reference computes log(softmax + 1e-7); the epsilon is numerically
    # irrelevant once the diagonal is masked — log_softmax is the stable form
    loss_row = -jnp.mean(jnp.sum(p * log_q, axis=1))
    log_q_t = jax.nn.log_softmax(logits.T, axis=1)
    loss_col = -jnp.mean(jnp.sum(p.T * log_q_t, axis=1))
    return (loss_row + loss_col) / 2.0


def graph_alignment_cosine(image_proj: jax.Array, graph_proj: jax.Array) -> jax.Array:
    """1 − mean cosine(image projection, graph projection) — the alignment
    term of the CLIP fine-tune (retrieval.ipynb cell 16/20)."""
    a = image_proj / jnp.maximum(jnp.linalg.norm(image_proj, axis=1, keepdims=True), 1e-12)
    b = graph_proj / jnp.maximum(jnp.linalg.norm(graph_proj, axis=1, keepdims=True), 1e-12)
    return 1.0 - jnp.mean(jnp.sum(a * b, axis=1))


def neighborhood_nce(z: jax.Array, pos_mask: jax.Array,
                     temperature: float = 0.07, eps: float = 1e-8) -> jax.Array:
    """Masked InfoNCE over the cosine-similarity matrix.

    Matches ``neighborhood_contrastive_loss`` (src/auxiliary.py:113-160)
    including the ±20 logit clamp and the no-positive row exclusion; the
    positive mask is precomputed (symmetric, zero diagonal) instead of the
    reference's Python loop over index pairs.
    """
    zn = z / jnp.maximum(jnp.linalg.norm(z, axis=1, keepdims=True), 1e-12)
    sim = jnp.dot(zn, zn.T, precision=jax.lax.Precision.HIGHEST) / temperature
    sim = jnp.clip(sim, -20.0, 20.0)
    n = z.shape[0]
    eye = jnp.eye(n, dtype=z.dtype)
    pos_mask = pos_mask * (1.0 - eye)
    exp_sim = jnp.exp(sim)
    pos_sim = jnp.sum(exp_sim * pos_mask, axis=1) + eps
    total_sim = jnp.sum(exp_sim * (1.0 - eye), axis=1) + eps
    log_prob = jnp.log(pos_sim / total_sim)
    has_pos = (jnp.sum(pos_mask, axis=1) > 0).astype(z.dtype)
    denom = jnp.sum(has_pos) + eps
    return -jnp.sum(log_prob * has_pos) / denom


def pairs_to_mask(pairs: jax.Array, n: int, dtype=jnp.float32) -> jax.Array:
    """[P, 2] index pairs → symmetric [n, n] 0/1 mask (host-free, scatter-based)."""
    mask = jnp.zeros((n, n), dtype)
    mask = mask.at[pairs[:, 0], pairs[:, 1]].set(1.0)
    mask = mask.at[pairs[:, 1], pairs[:, 0]].set(1.0)
    return mask


def hierarchical_triplet(z: jax.Array, parent_pairs: jax.Array,
                         neg_idx: jax.Array, margin: float = 0.1) -> jax.Array:
    """Child-parent vs random-negative squared-distance margin loss on
    L2-normalized embeddings (src/auxiliary.py:163-198).  Negative indices are
    sampled by the caller (jax.random) instead of the reference's per-sample
    Python rejection loop — collisions with the parent are masked out.
    """
    zn = z / jnp.maximum(jnp.linalg.norm(z, axis=1, keepdims=True), 1e-12)
    child = zn[parent_pairs[:, 0]]
    parent = zn[parent_pairs[:, 1]]
    neg = zn[neg_idx]
    pos_d = jnp.sum((child - parent) ** 2, axis=1)
    neg_d = jnp.sum((child - neg) ** 2, axis=1)
    valid = (neg_idx != parent_pairs[:, 1]).astype(z.dtype)
    per = jax.nn.relu(pos_d - neg_d + margin) * valid
    return jnp.sum(per) / jnp.maximum(jnp.sum(valid), 1.0)


def infonce_parent_neighbor(z: jax.Array, pairs: jax.Array,
                            neg_idx: jax.Array, temp: float = 0.1) -> jax.Array:
    """InfoNCE with 5 random negatives per pair on normalized embeddings.

    Matches one arm of ``training_loss`` (src/auxiliary.py:385-434):
    −mean(pos/τ − log(exp(pos/τ) + exp(mean_neg/τ))).

    Args:
        z: [N, D] embeddings; pairs: [P, 2]; neg_idx: [P, K] sampled negatives.
    """
    zn = z / jnp.maximum(jnp.linalg.norm(z, axis=1, keepdims=True), 1e-12)
    a = zn[pairs[:, 0]]
    b = zn[pairs[:, 1]]
    pos_sim = jnp.sum(a * b, axis=1)                         # [P]
    neg = zn[neg_idx]                                        # [P, K, D]
    neg_sim = jnp.mean(jnp.einsum("pd,pkd->pk", a, neg), axis=1)   # [P]
    return -jnp.mean(pos_sim / temp -
                     jnp.log(jnp.exp(pos_sim / temp) + jnp.exp(neg_sim / temp)))
