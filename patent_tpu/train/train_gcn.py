"""train_class_pro — GCN figure-pair classification training engine.

Re-design of ``train_pair_classification_model`` (reference src/train.py:
124-377): EnhancedVGAE over the full heterogeneous graph, 5-way CE over pair
connection levels, 0.8/0.1/0.1 split, AdamW + plateau LR decay + early stop,
confusion matrix + per-class P/R/F1 on test.

Device notes: the full-graph dense GCN forward is a chain of [N, N]·[N, D]
matmuls — one jit; the reference recomputes it per batch on the CPU-resident
loop (train.py:240), here it is fused into the step under jit so XLA shares
the encode across the pair gather + classifier head.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..metrics.classification import confusion_counts, per_class_prf
from ..models.gcn import (EnhancedVGAE, normalize_adjacency,
                          normalize_adjacency_host,
                          normalize_adjacency_sparse)
from ..utils.config import GCNTrainConfig
from ..utils.logging import MetricsLogger


def prepare_adjacency(adjacency, mode: str = "auto"):
    """Adjacency policy shared by the trainer and the embedding exporter.

    ``adjacency`` may be a dense ndarray or any scipy.sparse matrix (the
    ETL's native format, data/graph_build.py).  Modes:

      * ``"sparse"`` — sorted-COO SparseAdj; the GCN contracts via gather +
        segment-sum (O(E·D)).  The ONLY option at the reference's 2019
        scale (95,299 figures → a dense N² is ~36 GB).
      * ``"dense"`` — [N, N] on device; above 16k nodes normalized on host
        and shipped bf16 (the f32 intermediates are several N² copies).
      * ``"auto"`` — sparse for scipy input above 16k nodes, dense
        otherwise (small graphs run as dense matmuls; dense ndarray callers keep
        the proven dense path).
    """
    import scipy.sparse as sp

    is_sp = sp.issparse(adjacency)
    n = adjacency.shape[0]
    if mode == "auto":
        mode = "sparse" if (is_sp and n > 16384) else "dense"
    if mode == "sparse":
        return normalize_adjacency_sparse(
            adjacency if is_sp else sp.csr_matrix(adjacency))
    dense = adjacency.toarray() if is_sp else adjacency
    if n > 16384:
        return jnp.asarray(normalize_adjacency_host(dense))
    return normalize_adjacency(jnp.asarray(dense, jnp.float32))


def train_pair_classification(x: np.ndarray, adjacency,
                              pairs: np.ndarray, labels: np.ndarray,
                              cfg: GCNTrainConfig,
                              logger: MetricsLogger | None = None
                              ) -> tuple[dict, dict, dict]:
    """Returns (variables, history, test_report).  ``adjacency`` may be
    dense or scipy-sparse — see ``prepare_adjacency``."""
    logger = logger or MetricsLogger(print_every=20)
    rng = np.random.default_rng(cfg.seed)

    a_tilde = prepare_adjacency(adjacency, cfg.adjacency)
    x_dev = jnp.asarray(x, jnp.float32)
    model = EnhancedVGAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim,
                         num_layers=cfg.num_layers)
    p0 = jnp.asarray(pairs[:min(len(pairs), cfg.batch_size)], jnp.int32)
    variables = jax.jit(
        lambda k, xx, aa, pp: model.init(
            k, xx, aa, pp, method=EnhancedVGAE.encode_and_classify)
    )(jax.random.key(cfg.seed), x_dev, a_tilde, p0)

    schedule = optax.exponential_decay(cfg.learning_rate, transition_steps=200,
                                       decay_rate=0.7, staircase=True)
    optimizer = optax.adamw(schedule, weight_decay=cfg.weight_decay)
    opt_state = optimizer.init(variables["params"])

    # 0.8/0.1/0.1 split over pairs (train.py's split, 170-190)
    perm = rng.permutation(len(pairs))
    n_train = int(len(pairs) * cfg.train_ratio)
    n_val = int(len(pairs) * cfg.val_ratio)
    tr, va, te = (perm[:n_train], perm[n_train:n_train + n_val],
                  perm[n_train + n_val:])

    pairs_j = jnp.asarray(pairs, jnp.int32)
    labels_j = jnp.asarray(labels, jnp.int32)

    def _epoch_batches(idx_pool: np.ndarray, shuffle: bool
                       ) -> tuple[jax.Array, jax.Array]:
        """Fixed-shape [n_steps, B] index matrix + {0, 1} weight matrix.
        The ragged tail is padded CYCLICALLY from the pool (np.resize) with
        weight 0, so every batch keeps the jit shape and padded rows
        contribute nothing to losses/metrics.  Cyclic padding matters for
        training: the padded rows still enter the classifier's BatchNorm
        batch statistics (weights only zero the loss), and repeating ONE
        pair `pad` times skewed the tail batch's normalization — the
        leading entries of a fresh shuffle are a balanced resample."""
        perm = rng.permutation(idx_pool) if shuffle else np.asarray(idx_pool)
        n_steps = max(1, -(-len(perm) // cfg.batch_size))
        pad = n_steps * cfg.batch_size - len(perm)
        wt = np.ones(len(perm), np.float32)
        if pad:
            perm = np.resize(perm, n_steps * cfg.batch_size)
            wt = np.concatenate([wt, np.zeros(pad, np.float32)])
        return (jnp.asarray(perm.reshape(n_steps, cfg.batch_size), jnp.int32),
                jnp.asarray(wt.reshape(n_steps, cfg.batch_size)))

    # ONE device dispatch per epoch: the whole batch loop is a lax.scan
    # under jit.  Per-step dispatch is what dominated wall time at the
    # 2019 graph scale (same pathology train_hyp's epoch scan
    # eliminated).  Big arrays
    # (features, adjacency, pair tables) are jit ARGUMENTS so they are
    # never baked into the HLO as constants (compile-payload limits).
    @jax.jit
    def train_epoch(params, batch_stats, opt_state, key, x_dev, a_tilde,
                    pairs_j, labels_j, idx_mat, wt_mat):
        def body(carry, inp):
            params, batch_stats, opt_state, key = carry
            idx, wt = inp
            key, sub = jax.random.split(key)

            def loss_fn(p):
                logits, mut = model.apply(
                    {"params": p, "batch_stats": batch_stats},
                    x_dev, a_tilde, pairs_j[idx], deterministic=False,
                    method=EnhancedVGAE.encode_and_classify,
                    mutable=["batch_stats"], rngs={"dropout": sub})
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    logits, labels_j[idx])
                loss = jnp.sum(ce * wt) / jnp.maximum(jnp.sum(wt), 1.0)
                return loss, mut["batch_stats"]

            (loss, bstats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, bstats, opt_state, key), loss

        (params, batch_stats, opt_state, _), losses = jax.lax.scan(
            body, (params, batch_stats, opt_state, key), (idx_mat, wt_mat))
        return params, batch_stats, opt_state, jnp.mean(losses)

    @jax.jit
    def eval_epoch(params, batch_stats, x_dev, a_tilde, pairs_j, labels_j,
                   idx_mat, wt_mat):
        def body(_, inp):
            idx, wt = inp
            logits = model.apply(
                {"params": params, "batch_stats": batch_stats},
                x_dev, a_tilde, pairs_j[idx], deterministic=True,
                method=EnhancedVGAE.encode_and_classify)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, labels_j[idx])
            loss = jnp.sum(ce * wt) / jnp.maximum(jnp.sum(wt), 1.0)
            return None, (loss, jnp.argmax(logits, -1))

        _, (losses, preds) = jax.lax.scan(body, None, (idx_mat, wt_mat))
        return jnp.mean(losses), preds

    def evaluate(params, batch_stats, idx_pool) -> tuple[float, float, np.ndarray]:
        idx_mat, wt_mat = _epoch_batches(idx_pool, shuffle=False)
        loss, preds = eval_epoch(params, batch_stats, x_dev, a_tilde,
                                 pairs_j, labels_j, idx_mat, wt_mat)
        valid = np.asarray(wt_mat).reshape(-1) > 0.0
        preds_all = np.asarray(preds).reshape(-1)[valid]
        trues_all = np.asarray(labels_j)[
            np.asarray(idx_mat).reshape(-1)[valid]]
        return (float(loss), float((preds_all == trues_all).mean()),
                confusion_counts(trues_all, preds_all, 5))

    params, batch_stats = variables["params"], variables["batch_stats"]
    key = jax.random.key(cfg.seed)
    best_val, best = float("inf"), (params, batch_stats)
    patience_left = cfg.patience
    history: dict[str, list] = {"train_loss": [], "val_loss": [], "val_acc": []}
    step = 0
    for epoch in range(1, cfg.epochs + 1):
        idx_mat, wt_mat = _epoch_batches(tr, shuffle=True)
        key, sub = jax.random.split(key)
        params, batch_stats, opt_state, mean_loss = train_epoch(
            params, batch_stats, opt_state, sub, x_dev, a_tilde,
            pairs_j, labels_j, idx_mat, wt_mat)
        step += int(idx_mat.shape[0])
        tot = float(mean_loss)
        val_loss, val_acc, _ = evaluate(params, batch_stats, va)
        history["train_loss"].append(tot)
        history["val_loss"].append(val_loss)
        history["val_acc"].append(val_acc)
        logger.log(step, {"epoch": epoch, "train_loss": tot,
                          "val_loss": val_loss, "val_acc": val_acc},
                   force_print=True)
        if val_loss < best_val:
            best_val = val_loss
            best = (jax.tree.map(lambda v: v, params),
                    jax.tree.map(lambda v: v, batch_stats))
            patience_left = cfg.patience
        else:
            patience_left -= 1
            if patience_left <= 0:
                break

    params, batch_stats = best
    test_loss, test_acc, cm = evaluate(params, batch_stats, te)
    prf = per_class_prf(cm)
    test_report = {
        "test_loss": test_loss, "test_acc": test_acc,
        "confusion_matrix": cm.tolist(),
        "precision": prf["precision"].tolist(),
        "recall": prf["recall"].tolist(),
        "f1": prf["f1"].tolist(),
    }
    return {"params": params, "batch_stats": batch_stats}, history, test_report


def export_graph_embeddings(variables: dict, x: np.ndarray,
                            adjacency, hidden_dim: int,
                            latent_dim: int, num_layers: int,
                            figure_index: dict[str, int],
                            adjacency_mode: str = "auto"
                            ) -> dict[str, np.ndarray]:
    """Full-graph inference → L2-normalized per-figure embedding dict
    (reference compute_graph_embeddings.py:16-62: infer, normalize, key by
    the image index).  Same adjacency policy as the trainer
    (``prepare_adjacency``) so exported embeddings match training."""
    model = EnhancedVGAE(hidden_dim=hidden_dim, latent_dim=latent_dim,
                         num_layers=num_layers)
    a_tilde = prepare_adjacency(adjacency, adjacency_mode)
    z = model.apply({"params": variables["params"],
                     "batch_stats": variables["batch_stats"]},
                    jnp.asarray(x, jnp.float32), a_tilde, deterministic=True)
    z = np.asarray(z)
    return {name: z[idx] for name, idx in figure_index.items()}
