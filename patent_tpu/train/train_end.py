"""train_end_2 — joint CLIP + hyperbolic end-to-end training engine.

Re-design of ``train_end_to_end_old`` (reference src/train.py:2415-3106) and
the unreachable hierarchical variant (train.py:415-750):

* images (anchors ∥ positives) through the ViT (last N blocks trainable,
  train.py:2459-2464) → features,
* CLIP-style InfoNCE on the image features,
* the hyperbolic head encodes the SAME features; hyperbolic losses =
  sample→prototype retrieval + hierarchy margins + regs (train.py:2700-2760),
* total = w·clip_loss + (1−w)·hyperbolic_loss (train.py:2760),
* three optimizer groups — AdamW on the CLIP blocks, Adam on the Euclidean
  hyperbolic-encoder params, Riemannian Adam on the label table
  (train.py:2641-2643) — composed as one ``optax.multi_transform``,
* the whole step is a single jit (the reference runs three host-side
  optimizers and per-pair Python loss loops).
"""

from __future__ import annotations

import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..losses import (
    dist0_band_regularizers,
    hierarchical_margin_losses,
    hyperbolic_info_nce,
    multi_positive_nt_xent,
)
from ..models.hyperbolic import HyperbolicEmbeddingModel
from ..models.vit import VisionConfig, VisionTransformer, finetune_param_labels
from ..utils.config import EndToEndConfig
from ..utils.logging import MetricsLogger
from .optim import manifold_mask, riemannian_adam


def init_end_to_end(vision_config: VisionConfig, cfg: EndToEndConfig,
                    label_num: int, clip_params: Any | None = None,
                    seed: int = 0):
    """Build ((vit, hyp), params, optimizer, opt_state)."""
    # cls_last: gradient-exact CLS-only last layer — the other S−1 rows
    # of the last block feed nothing
    vit = VisionTransformer(vision_config, dtype=jnp.bfloat16, cls_last=True)
    key = jax.random.key(seed)
    dummy = jnp.zeros((1, vision_config.image_size, vision_config.image_size, 3))
    vit_params = clip_params if clip_params is not None else \
        jax.jit(vit.init)(key, dummy)["params"]

    hyp = HyperbolicEmbeddingModel(
        feature_dim=vision_config.projection_dim, embed_dim=cfg.embed_dim,
        label_num=label_num, c=cfg.curvature)
    hyp_params = jax.jit(hyp.init)(key, jnp.zeros(
        (1, vision_config.projection_dim)))["params"]

    params = {"vit": vit_params, "hyp": hyp_params}

    # three optimizer groups (train.py:2641-2643)
    vit_labels = finetune_param_labels(vit_params, cfg.trainable_blocks,
                                       vision_config.num_layers)
    vit_labels = jax.tree.map(
        lambda l: "clip" if l == "train" else "frozen", vit_labels)
    hyp_mask = manifold_mask(hyp_params)
    hyp_labels = jax.tree.map(lambda m: "riemann" if m else "euclid", hyp_mask)
    labels = {"vit": vit_labels, "hyp": hyp_labels}

    optimizer = optax.multi_transform(
        {"clip": optax.adamw(cfg.lr_clip),
         "euclid": optax.adam(cfg.lr_euclidean),
         "riemann": riemannian_adam(cfg.lr_label_emb, c=cfg.curvature,
                                    mask=True),
         "frozen": optax.set_to_zero()},
        labels)
    opt_state = optimizer.init(params)
    return (vit, hyp), params, optimizer, opt_state


def make_end_to_end_step(vit: VisionTransformer, hyp: HyperbolicEmbeddingModel,
                         optimizer, cfg: EndToEndConfig):
    """(params, opt_state, images[2B], pos_patents[B], neg_patents[B, K],
    implication, key) → updated state + metrics."""
    c = cfg.curvature

    def loss_fn(params, images, pos_patents, neg_patents, implication, key):
        feats = vit.apply({"params": params["vit"]}, images)          # [2B, D]
        b = pos_patents.shape[0]
        clip_loss = multi_positive_nt_xent(feats, 1.0 / 0.07)

        enc = hyp.apply({"params": params["hyp"]}, feats,
                        deterministic=False, rngs={"dropout": key})
        anchors = enc[:b]
        label_emb = params["hyp"]["label_emb"]

        from ..ops import poincare
        pos_d = poincare.dist(anchors, label_emb[pos_patents], c)
        neg_d = jnp.mean(poincare.dist(anchors[:, None, :],
                                       label_emb[neg_patents], c), axis=1)
        retrieval = jnp.mean(jax.nn.relu(pos_d - neg_d + 0.1))
        inside, disjoint = hierarchical_margin_losses(label_emb, implication,
                                                      None, c)
        label_reg, inst_reg = dist0_band_regularizers(label_emb, anchors, c)
        hyp_contrastive = hyperbolic_info_nce(anchors, enc[b:], c)
        hyp_loss = (retrieval + 3.0 * (inside + disjoint) +
                    0.01 * (label_reg + inst_reg) + hyp_contrastive)

        total = cfg.clip_weight * clip_loss + (1 - cfg.clip_weight) * hyp_loss
        return total, {"total_loss": total, "clip_loss": clip_loss,
                       "hyp_loss": hyp_loss, "retrieval_loss": retrieval}

    @jax.jit
    def step(params, opt_state, images, pos_patents, neg_patents,
             implication, key):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, images, pos_patents, neg_patents, implication, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, metrics

    return step


def run_end_to_end_synthetic(path: str, epochs: int = 2,
                             logger: MetricsLogger | None = None,
                             image_size: int = 32) -> dict:
    """Run the joint trainer for a few epochs on the synthetic corpus —
    the CLI ``train_end``/``train_end_2`` action's out-of-the-box path."""
    from ..data import build_hetero_graph, synthetic
    from ..input.pipeline import decode_image
    from ..models.vit import VisionConfig

    logger = logger or MetricsLogger(print_every=5)
    cfg = EndToEndConfig(batch_size=8, image_size=image_size, embed_dim=16)
    vision_config = VisionConfig(image_size=image_size, patch_size=8,
                                 hidden_dim=64, num_layers=2, num_heads=4,
                                 mlp_dim=128, projection_dim=32)

    records, images_dir = synthetic.write_synthetic_corpus(
        os.path.join(path, "synthetic_corpus"), num_patents=12,
        figures_per_patent=3, image_size=image_size)
    graph = build_hetero_graph(records)
    label_num = graph.num_nodes - len(graph.figure_index)

    # anchor/positive pairs: consecutive figures of each patent
    by_patent: dict[str, list] = {}
    for r in records:
        by_patent.setdefault(r.patent_id, []).append(r)
    pairs = []
    for pid, figs in by_patent.items():
        for i in range(len(figs) - 1):
            pairs.append((figs[i], figs[i + 1]))

    (vit, hyp), params, optimizer, opt_state = init_end_to_end(
        vision_config, cfg, label_num)
    step = make_end_to_end_step(vit, hyp, optimizer, cfg)

    # patent→medium implication pairs, relative to label table
    off = graph.offsets
    p0 = off["patents"]
    implication = []
    coo = graph.adjacency.tocoo()
    for i, j in zip(coo.row, coo.col):
        if p0 <= i < off["medium_cpcs"] <= j < off["big_cpcs"]:
            implication.append((i - p0, j - p0))
    implication = jnp.asarray(np.asarray(implication, np.int32))

    rng = np.random.default_rng(0)
    key = jax.random.key(0)
    n_steps = 0
    last = {}
    for _epoch in range(epochs):
        rng.shuffle(pairs)
        for s in range(0, len(pairs) - cfg.batch_size + 1, cfg.batch_size):
            chunk = pairs[s:s + cfg.batch_size]
            imgs = np.stack(
                [decode_image(os.path.join(images_dir, r.figure_id),
                              image_size) for r, _ in chunk] +
                [decode_image(os.path.join(images_dir, r2.figure_id),
                              image_size) for _, r2 in chunk])
            pos = np.asarray([graph.patent_index[r.patent_id]
                              for r, _ in chunk], np.int32)
            neg = rng.integers(0, len(graph.patent_index),
                               (len(chunk), 2)).astype(np.int32)
            key, sub = jax.random.split(key)
            params, opt_state, metrics = step(
                params, opt_state, jnp.asarray(imgs), jnp.asarray(pos),
                jnp.asarray(neg), implication, sub)
            n_steps += 1
            last = {k: float(v) for k, v in metrics.items()}
            logger.log(n_steps, last)
    logger.log(n_steps, last, force_print=True)
    return {"params": params, "metrics": last, "steps": n_steps}
