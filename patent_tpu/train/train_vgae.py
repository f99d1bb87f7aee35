"""VGAE adjacency-reconstruction training (link prediction).

The reference builds a VGAE model (src/models.py:881-903) with clamped
BCE+KL losses (src/auxiliary.py:36-79) and an edge splitter
(src/process_graph.py:17-98) but never wires a CLI action for it; this
engine completes the family: train the VGAE on the training adjacency,
validate with link-prediction ROC-AUC/AP on held-out edges.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..data.edges import EdgeSplit, link_prediction_scores, split_edges
from ..models.gcn import VGAE, normalize_adjacency, normalize_adjacency_sparse
from ..utils.logging import MetricsLogger


def train_vgae_link_prediction(x: np.ndarray, adjacency,
                               hidden_dim: int = 64, latent_dim: int = 32,
                               epochs: int = 50, learning_rate: float = 1e-2,
                               val_ratio: float = 0.05, test_ratio: float = 0.1,
                               seed: int = 42,
                               logger: MetricsLogger | None = None,
                               mode: str = "auto"
                               ) -> tuple[dict, EdgeSplit, dict]:
    """Returns (variables, edge_split, test_report).

    ``mode``: ``"dense"`` reconstructs the full sigmoid(Z Zᵀ) and trains
    class-balanced BCE over all N² entries (the reference objective,
    auxiliary.py:36-58); ``"sampled"`` trains BCE over the train edges plus
    an equal number of per-step resampled random pairs, scoring pairs
    straight from z — O(E·d) per step, the only option at the 2019 graph
    scale (a 108k-node reconstruction is 47 GB).  ``"auto"`` picks sampled
    above 16k nodes.  Both validate on the same held-out edge split."""
    import scipy.sparse as sp

    logger = logger or MetricsLogger(print_every=10)
    if not sp.issparse(adjacency):
        adjacency = sp.csr_matrix(adjacency)
    split = split_edges(adjacency, val_ratio=val_ratio, test_ratio=test_ratio,
                        seed=seed)
    if mode == "auto":
        mode = "sampled" if adjacency.shape[0] > 16384 else "dense"
    if mode == "sampled":
        return _train_vgae_sampled(x, split, hidden_dim, latent_dim, epochs,
                                   learning_rate, seed, logger)
    a_train = jnp.asarray(split.train_adjacency.toarray(), jnp.float32)
    a_tilde = normalize_adjacency(a_train)
    a_target = jnp.asarray((split.train_adjacency.toarray() > 0)
                           .astype(np.float32))
    x_dev = jnp.asarray(x, jnp.float32)

    model = VGAE(hidden_dim=hidden_dim, latent_dim=latent_dim)
    variables = jax.jit(model.init)(jax.random.key(seed), x_dev, a_tilde)
    optimizer = optax.adam(learning_rate)
    opt_state = optimizer.init(variables["params"])

    @jax.jit
    def step(params, batch_stats, opt_state, x_dev, a_tilde, a_target):
        def loss_fn(p):
            (z, a_rec), mut = model.apply(
                {"params": p, "batch_stats": batch_stats}, x_dev, a_tilde,
                deterministic=False, mutable=["batch_stats"])
            eps = 1e-7
            a_rec_c = jnp.clip(a_rec, eps, 1.0 - eps)
            # class-balanced BCE: edges are rare, weight positives up
            n_pos = jnp.maximum(jnp.sum(a_target), 1.0)
            n_neg = jnp.maximum(a_target.size - n_pos, 1.0)
            w_pos = a_target.size / (2.0 * n_pos)
            w_neg = a_target.size / (2.0 * n_neg)
            bce = -(w_pos * a_target * jnp.log(a_rec_c) +
                    w_neg * (1 - a_target) * jnp.log(1 - a_rec_c))
            loss = jnp.sum(bce) / a_target.size
            return loss, mut["batch_stats"]
        (loss, bstats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), bstats, opt_state, loss

    params, batch_stats = variables["params"], variables["batch_stats"]
    best_auc, best = 0.0, (params, batch_stats)
    for epoch in range(1, epochs + 1):
        params, batch_stats, opt_state, loss = step(
            params, batch_stats, opt_state, x_dev, a_tilde, a_target)
        if epoch % 5 == 0 or epoch == epochs:
            (z, a_rec) = model.apply(
                {"params": params, "batch_stats": batch_stats}, x_dev,
                a_tilde, deterministic=True)
            val = link_prediction_scores(np.asarray(a_rec), split.val_edges,
                                         split.val_non_edges)
            logger.log(epoch, {"loss": float(loss),
                               "val_auc": val["roc_auc"],
                               "val_ap": val["average_precision"]},
                       force_print=True)
            if val["roc_auc"] > best_auc:
                best_auc = val["roc_auc"]
                best = (jax.tree.map(lambda v: v, params),
                        jax.tree.map(lambda v: v, batch_stats))

    params, batch_stats = best
    (_z, a_rec) = model.apply({"params": params, "batch_stats": batch_stats},
                              x_dev, a_tilde, deterministic=True)
    test = link_prediction_scores(np.asarray(a_rec), split.test_edges,
                                  split.test_non_edges)
    return ({"params": params, "batch_stats": batch_stats}, split, test)


def _train_vgae_sampled(x: np.ndarray, split: EdgeSplit, hidden_dim: int,
                        latent_dim: int, epochs: int, learning_rate: float,
                        seed: int, logger: MetricsLogger
                        ) -> tuple[dict, EdgeSplit, dict]:
    """Sampled-edge VGAE: sparse adjacency, per-pair BCE from latents.

    Per step: positives = ALL train edges; negatives = the same count of
    freshly sampled random pairs (collision probability with a true edge is
    E/N² ≈ 2e-5 at reference scale — label noise far below the loss's
    resolution; the reference's own non-edge sampler accepts the same
    approximation during eval-set construction, process_graph.py:60-80).
    The encoder forward is the sparse O(E·D) path, so one step at the 2019
    scale costs ~20 ms instead of being impossible."""
    a_tilde = normalize_adjacency_sparse(split.train_adjacency)
    x_dev = jnp.asarray(x, jnp.float32)
    n = split.train_adjacency.shape[0]
    train_edges = jnp.asarray(split.train_edges, jnp.int32)     # [Et, 2]

    model = VGAE(hidden_dim=hidden_dim, latent_dim=latent_dim)
    variables = jax.jit(
        lambda k, xx, aa: model.init(k, xx, aa, method=VGAE.encode)
    )(jax.random.key(seed), x_dev, a_tilde)
    optimizer = optax.adam(learning_rate)
    opt_state = optimizer.init(variables["params"])

    # a chunk of steps is ONE lax.scan dispatch (the eval cadence, 5):
    # one host dispatch per chunk instead of per step (same fix as
    # train_gcn / train_hyp's epoch scans)
    @functools.partial(jax.jit, static_argnames=("n_steps",))
    def step_chunk(params, batch_stats, opt_state, key, x_dev, a_tilde,
                   train_edges, n_steps: int):
        def body(carry, _):
            params, batch_stats, opt_state, key = carry
            key, sub = jax.random.split(key)
            neg = jax.random.randint(sub, train_edges.shape, 0, n)
            # reroll self-pairs (i, i): with L2-normalized latents their
            # logit is exactly 1 — a maximally-confident false negative
            # (~1/n of draws, tiny but systematic); +1 mod n breaks the tie
            neg = neg.at[:, 1].set(
                jnp.where(neg[:, 0] == neg[:, 1], (neg[:, 1] + 1) % n,
                          neg[:, 1]))

            def loss_fn(p):
                z, mut = model.apply(
                    {"params": p, "batch_stats": batch_stats}, x_dev,
                    a_tilde, deterministic=False, method=VGAE.encode,
                    mutable=["batch_stats"])
                def logits(pairs):
                    return jnp.sum(z[pairs[:, 0]] * z[pairs[:, 1]], axis=1)
                bce = (jnp.mean(jax.nn.softplus(-logits(train_edges)))
                       + jnp.mean(jax.nn.softplus(logits(neg)))) * 0.5
                return bce, mut["batch_stats"]

            (loss, bstats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, bstats, opt_state, key), loss

        (params, batch_stats, opt_state, key), losses = jax.lax.scan(
            body, (params, batch_stats, opt_state, key), None,
            length=n_steps)
        return params, batch_stats, opt_state, key, losses[-1]

    @jax.jit
    def encode(params, batch_stats, x_dev, a_tilde):
        return model.apply({"params": params, "batch_stats": batch_stats},
                           x_dev, a_tilde, deterministic=True,
                           method=VGAE.encode)

    # evaluation fetches ONLY the E pair scores ([E] f32, ~100 KB), never
    # the [N, latent] matrix (55 MB at 2019 scale, once per eval)
    @jax.jit
    def pair_scores(params, batch_stats, x_dev, a_tilde, pairs):
        z = encode(params, batch_stats, x_dev, a_tilde)
        return jax.nn.sigmoid(
            jnp.sum(z[pairs[:, 0]] * z[pairs[:, 1]], axis=1))

    def eval_split(params, batch_stats, edges, non_edges) -> dict:
        from ..data.edges import _pos_neg_metrics

        pos = np.asarray(pair_scores(params, batch_stats, x_dev, a_tilde,
                                     jnp.asarray(edges, jnp.int32)))
        neg = np.asarray(pair_scores(params, batch_stats, x_dev, a_tilde,
                                     jnp.asarray(non_edges, jnp.int32)))
        return _pos_neg_metrics(pos, neg)

    params, batch_stats = variables["params"], variables["batch_stats"]
    key = jax.random.key(seed)
    best_auc, best = 0.0, (params, batch_stats)
    epoch = 0
    while epoch < epochs:
        n_steps = min(5 - epoch % 5, epochs - epoch)
        params, batch_stats, opt_state, key, loss = step_chunk(
            params, batch_stats, opt_state, key, x_dev, a_tilde,
            train_edges, n_steps=n_steps)
        epoch += n_steps
        if epoch % 5 == 0 or epoch == epochs:
            val = eval_split(params, batch_stats, split.val_edges,
                             split.val_non_edges)
            logger.log(epoch, {"loss": float(loss),
                               "val_auc": val["roc_auc"],
                               "val_ap": val["average_precision"]},
                       force_print=True)
            if val["roc_auc"] > best_auc:
                best_auc = val["roc_auc"]
                best = (jax.tree.map(lambda v: v, params),
                        jax.tree.map(lambda v: v, batch_stats))

    params, batch_stats = best
    test = eval_split(params, batch_stats, split.test_edges,
                      split.test_non_edges)
    return ({"params": params, "batch_stats": batch_stats}, split, test)
