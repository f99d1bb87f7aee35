"""CLIP fine-tuning with graph alignment — the L8 pipeline stage.

Re-design of ``fine_tune_clip`` + ``MultiPositiveContrastiveLoss``
v2 (reference notebooks/retrieval.ipynb cell 20, v1 in cell 16):

* anchors ∥ positives in one [2B] image batch through the ViT (bf16),
* NT-Xent with soft multi-positive targets and a learnable temperature
  (``logit_scale``, exp-clamped at 100),
* alignment head: learnable graph-node embedding table (init from the VGAE
  matrix, PCA-whitened to ``graph_proj_dim``) + independent image/graph
  projectors; loss term α·(1 − cos) with α warm-up over 5 epochs,
* 4-group optimizer via ``optax.multi_transform`` (CLIP 2e-5, projectors
  2e-4, embedding table 1e-4, logit_scale 5e-4 — cell 20's AdamW groups),
  with the CLIP group restricted to the last N vision blocks
  (``finetune_param_labels``).

The whole train step is ONE jit; the reference runs separate host-side loss
module + optimizer objects.

The tower computes only the CLS row of its last layer (``cls_last``) and
runs attention through cuDNN on a GPU (``ops.attention``); model init is
jitted.  Input is uint8 pair batches normalized on device (PairBatcher
out_dtype="u8"), decoded by the shared thread pool with one-batch-ahead
prefetch, so the loop is device-bound, not host-bound.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..losses import graph_alignment_cosine, multi_positive_nt_xent
from ..models.layers import Scope, dense, init_dense, normal
from ..models.vit import VisionConfig, VisionTransformer, finetune_param_labels
from ..utils.config import ClipFinetuneConfig


@dataclasses.dataclass(frozen=True)
class AlignmentHead:
    """Learnable graph-embedding table + the two projectors (cell 20)."""

    num_nodes: int
    graph_dim: int = 128          # PCA-whitened VGAE dim (cell 19)
    proj_dim: int = 128
    init_tau: float = 0.10

    def init(self, rng: jax.Array, image_features: jax.Array,
             node_idx: jax.Array | None = None) -> dict:
        root = Scope(rng)
        root.param("graph_embedding", normal(0.02),
                   (self.num_nodes, self.graph_dim))
        root.param("logit_scale", lambda _k, _s, dtype: jnp.asarray(
            math.log(1.0 / self.init_tau), dtype), ())
        init_dense(root, "Dense_0", image_features.shape[-1], self.proj_dim)
        init_dense(root, "Dense_1", self.graph_dim, self.proj_dim)
        return {"params": root.params}

    def apply(self, variables: dict, image_features: jax.Array,
              node_idx: jax.Array
              ) -> tuple[jax.Array, jax.Array, jax.Array]:
        """→ (projected image feats [2B], projected graph feats [B], logit_scale)."""
        p = variables["params"]
        z = jax.nn.relu(dense(p["Dense_0"], image_features))
        g = jax.nn.relu(dense(p["Dense_1"], p["graph_embedding"][node_idx]))
        scale = jnp.clip(jnp.exp(p["logit_scale"]), max=100.0)
        return z, g, scale


def pca_whiten(matrix: np.ndarray, dim: int = 128) -> np.ndarray:
    """PCA-whiten the VGAE embedding matrix to ``dim`` (cell 19
    ``torch.pca_lowrank`` + scaling)."""
    x = matrix - matrix.mean(axis=0, keepdims=True)
    u, s, _vt = np.linalg.svd(x, full_matrices=False)
    k = min(dim, s.shape[0])
    white = u[:, :k] * np.sqrt(x.shape[0] - 1)
    if k < dim:
        white = np.pad(white, ((0, 0), (0, dim - k)))
    return white.astype(np.float32)


def init_finetune_state(vision_config: VisionConfig, cfg: ClipFinetuneConfig,
                        vgae_matrix: np.ndarray,
                        clip_params: Any | None = None,
                        seed: int = 0):
    """Build (models, params, optimizer, opt_state) for fine-tuning.

    ``vgae_matrix``: [num_graph_nodes, D] graph embeddings (will be
    PCA-whitened to cfg.graph_proj_dim and used as the table init).
    """
    vit = VisionTransformer(vision_config, dtype=jnp.bfloat16,
                            cls_last=cfg.cls_last,
                            keep_tokens=cfg.keep_tokens)
    key = jax.random.key(seed)
    dummy = jnp.zeros((1, vision_config.image_size, vision_config.image_size, 3))
    vit_params = clip_params if clip_params is not None else \
        jax.jit(vit.init)(key, dummy)["params"]

    white = pca_whiten(vgae_matrix, cfg.graph_proj_dim)
    head = AlignmentHead(num_nodes=white.shape[0],
                         graph_dim=cfg.graph_proj_dim,
                         proj_dim=cfg.graph_proj_dim,
                         init_tau=cfg.init_tau)
    head_params = jax.jit(head.init)(key, jnp.zeros((2, vision_config.projection_dim)),
                            jnp.zeros((1,), jnp.int32))["params"]
    head_params = dict(head_params)
    head_params["graph_embedding"] = jnp.asarray(white)

    params = {"vit": vit_params, "head": head_params}

    # 4-group optimizer (cell 20): clip / projectors / embedding / logit_scale
    vit_labels = finetune_param_labels(vit_params, cfg.trainable_blocks,
                                       vision_config.num_layers)
    vit_labels = jax.tree.map(
        lambda l: "clip" if l == "train" else "frozen", vit_labels)

    def head_label(path, _leaf):
        ks = jax.tree_util.keystr(path)
        if "graph_embedding" in ks:
            return "embed"
        if "logit_scale" in ks:
            return "logit"
        return "proj"

    labels = {"vit": vit_labels,
              "head": jax.tree_util.tree_map_with_path(head_label, head_params)}
    optimizer = optax.multi_transform(
        {"clip": optax.adamw(cfg.lr_clip, weight_decay=cfg.weight_decay),
         "proj": optax.adamw(cfg.lr_proj, weight_decay=cfg.weight_decay),
         "embed": optax.adamw(cfg.lr_embed, weight_decay=cfg.weight_decay),
         "logit": optax.adamw(cfg.lr_logit_scale, weight_decay=cfg.weight_decay),
         "frozen": optax.set_to_zero()},
        labels)
    opt_state = optimizer.init(params)
    return (vit, head), params, optimizer, opt_state


def make_finetune_step(vit: VisionTransformer, head: AlignmentHead,
                       optimizer, cfg: ClipFinetuneConfig):
    """(params, opt_state, images[2B], node_idx[B], alpha) → updated state.

    ``images`` = anchors ∥ positives; ``node_idx`` = graph node per anchor;
    ``alpha`` is the warm-up-scheduled alignment weight (host scalar → device
    arg so the step never recompiles across epochs).
    """

    from ..input.pipeline import device_normalize

    def loss_fn(params, images, node_idx, alpha):
        # raw u8 batches (PairBatcher(out_dtype="u8")) normalize on device —
        # 4× less host→device transfer; f32 callers pass through
        images = device_normalize(images)
        # no stop_gradient over the frozen subtree: the optimizer update
        # lives in the same jit and maps frozen grads through set_to_zero,
        # so XLA drops the backward chain below the first trainable block
        feats = vit.apply({"params": params["vit"]}, images)           # [2B, D]
        z, g, scale = head.apply({"params": params["head"]}, feats, node_idx)
        ce = multi_positive_nt_xent(z, scale)
        b = node_idx.shape[0]
        align = graph_alignment_cosine(z[:b], g)
        loss = (1.0 - alpha) * ce + alpha * align
        return loss, {"loss": loss, "cross_loss": ce, "align_loss": align,
                      "tau": 1.0 / scale}

    @jax.jit
    def step(params, opt_state, images, node_idx, alpha):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, images, node_idx, alpha)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, metrics

    @jax.jit
    def eval_step(params, images, node_idx, alpha):
        _, metrics = loss_fn(params, images, node_idx, alpha)
        return metrics

    return step, eval_step


def pad_graph_table(params, opt_state, model_size: int):
    """Zero-pad the alignment head's ``graph_embedding`` table (params AND
    optimizer moments) along axis 0 to the next multiple of ``model_size``
    so it can be genuinely row-sharded.  Padded rows are inert: no
    ``node_idx`` ever gathers them, so their gradient — and their AdamW
    update — is exactly zero.  Returns (params, opt_state, real, padded)."""
    real = None

    def pad(path, leaf):
        nonlocal real
        ks = jax.tree_util.keystr(path)
        if "graph_embedding" in ks and getattr(leaf, "ndim", 0) >= 1:
            real = leaf.shape[0]
            target = -(-leaf.shape[0] // model_size) * model_size
            if target != leaf.shape[0]:
                pad_width = [(0, target - leaf.shape[0])] + \
                    [(0, 0)] * (leaf.ndim - 1)
                return jnp.pad(leaf, pad_width)
        return leaf

    params = jax.tree_util.tree_map_with_path(pad, params)
    opt_state = jax.tree_util.tree_map_with_path(pad, opt_state)
    if real is None:
        raise ValueError("no graph_embedding leaf found in params")
    padded = -(-real // model_size) * model_size
    return params, opt_state, real, padded


def shard_finetune_state(mesh, params, opt_state):
    """Place the fine-tune state on a (data, model) mesh: the graph
    embedding table — the one head parameter that grows with graph size
    (nodes ≈ figures + patents + CPCs, 44k-107k in the reference corpora) —
    row-sharded over ``model``; the ViT and projectors replicated.
    Optimizer moments follow their params.  Tables that do not divide the
    model axis must go through ``pad_graph_table`` first."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    model_size = mesh.shape["model"]

    def spec_for(path, leaf):
        ks = jax.tree_util.keystr(path)
        if "graph_embedding" in ks and getattr(leaf, "ndim", 0) >= 1:
            if leaf.shape[0] % model_size:
                raise ValueError(
                    f"graph table rows ({leaf.shape[0]}) must divide the "
                    f"model axis ({model_size}); use pad_graph_table first")
            return NamedSharding(mesh, P("model"))
        return NamedSharding(mesh, P())

    params = jax.device_put(
        params, jax.tree_util.tree_map_with_path(spec_for, params))
    opt_state = jax.device_put(
        opt_state, jax.tree_util.tree_map_with_path(spec_for, opt_state))
    return params, opt_state


def make_sharded_finetune_step(mesh, vit: VisionTransformer,
                               head: AlignmentHead, optimizer,
                               cfg: ClipFinetuneConfig):
    """The cell-20 fine-tune step over a (data, model) mesh — the L8
    flagship's multi-chip path (VERDICT r3 #3).

    Images (anchors ∥ positives, [2B]) and node indices shard over
    ``data``; XLA inserts the gradient psum, the all-gather for the
    NT-Xent's global 2B×2B similarity matrix, and the collective gathers
    into the row-sharded graph table (``shard_finetune_state``).  The step
    function IS the single-device one (``make_finetune_step``) — sharding
    lives entirely in data/parameter placement, so sharded == single-device
    is structural, and is still executed as a parity test
    (tests/test_sharded_train.py) plus the driver's multichip dryrun.

    Returns (step, eval_step, place_batch).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    step, eval_step = make_finetune_step(vit, head, optimizer, cfg)
    data_sharding = NamedSharding(mesh, P("data"))

    def place_batch(images, node_idx):
        n_data = mesh.shape["data"]
        # check BOTH arrays: images is 2B rows and node_idx is B — 2B
        # divisible does not imply B divisible (e.g. 3 pairs on data=2
        # passes the image check, then device_put fails opaquely on the
        # [3] node_idx)
        if images.shape[0] % n_data or node_idx.shape[0] % n_data:
            raise ValueError(
                f"global image batch ({images.shape[0]}) and pair count "
                f"({node_idx.shape[0]}) must divide the data axis "
                f"({n_data})")
        return (jax.device_put(jnp.asarray(images), data_sharding),
                jax.device_put(jnp.asarray(node_idx), data_sharding))

    return step, eval_step, place_batch


def alpha_schedule(epoch: int, cfg: ClipFinetuneConfig) -> float:
    """α warm-up over the first ``warmup_epochs`` epochs (cell 20)."""
    if epoch < cfg.warmup_epochs:
        return cfg.alpha_max * (epoch + 1) / cfg.warmup_epochs
    return cfg.alpha_max


def run_finetune(anchor_paths, positive_paths, graph_node_idx,
                 vgae_matrix, vision_config: VisionConfig,
                 cfg: ClipFinetuneConfig,
                 val_fraction: float = 0.1,
                 clip_params=None, logger=None, ckpt=None,
                 image_size: int | None = None,
                 cache=None) -> tuple[dict, dict]:
    """Full fine-tuning loop (retrieval.ipynb cell 20 ``fine_tune_clip``):

    * anchors ∥ positives decoded through the input pipeline,
    * patent-aware train/val split is the CALLER's job (pass disjoint lists
      built with data.split_query_gallery — the reference asserts zero
      patent overlap, train.py:4236); here the last ``val_fraction`` of
      pairs is held out as a seeded RANDOM subset (not the list tail),
    * α warm-up per epoch; validation every ``cfg.val_every`` batches and at
      epoch end; best-val checkpoint via ``ckpt`` (reference saves
      ``<name>_best`` via save_pretrained).

    Args:
        anchor_paths / positive_paths: same-length image path lists (pairs).
        graph_node_idx: [len(anchor_paths)] graph-node row per anchor
            (the reference maps anchor path → VGAE row via a path-keyed
            dict, cell 20 ``graph_id_map``).
    Returns (best_params, history).
    """
    from ..input.pipeline import PairBatcher
    from ..utils.logging import MetricsLogger

    logger = logger or MetricsLogger(print_every=10)
    image_size = image_size or cfg.image_size
    rng = np.random.default_rng(cfg.seed)
    n = len(anchor_paths)
    assert len(positive_paths) == n and len(graph_node_idx) == n
    n_val = max(1, int(n * val_fraction))
    order = rng.permutation(n)
    val_ids = order[:n_val]
    train_ids = order[n_val:]

    (vit, head), params, optimizer, opt_state = init_finetune_state(
        vision_config, cfg, vgae_matrix, clip_params=clip_params,
        seed=cfg.seed)
    step, eval_step = make_finetune_step(vit, head, optimizer, cfg)

    # threaded decode + one-batch-ahead prefetch: the host decodes the next
    # anchor∥positive batch while the device steps on the current one (the
    # reference uses DataLoader(num_workers=16-32), train.py:4292-4308)
    # u8 batches + on-device normalization (loss_fn branches on dtype):
    # 4× less transfer per step, and this loop's images never leave it.
    # With a decoded-u8 ``cache``, epoch 1 fills it and every later epoch
    # (plus every validation pass) streams at cache-read speed — the
    # reference re-decodes EVERY image EVERY epoch
    # (/root/reference/src/train.py:4292-4308)
    batcher = PairBatcher(anchor_paths, positive_paths, graph_node_idx,
                          batch_size=cfg.batch_size, image_size=image_size,
                          num_workers=cfg.num_workers, out_dtype="u8",
                          cache=cache)

    def validate(params, alpha):
        tot, nb = 0.0, 0
        for images, nodes in batcher.epoch(val_ids):
            m = eval_step(params, jnp.asarray(images), jnp.asarray(nodes),
                          alpha)
            tot += float(m["loss"])
            nb += 1
        return tot / nb if nb else float("inf")

    best_val = float("inf")
    best_params = params
    history: dict[str, list] = {"train_loss": [], "val_loss": []}
    it = 0
    try:
        for epoch in range(cfg.epochs):
            alpha = alpha_schedule(epoch, cfg)
            perm = rng.permutation(train_ids)
            tot, nb = 0.0, 0
            for images, nodes in batcher.epoch(perm):
                params, opt_state, metrics = step(
                    params, opt_state, jnp.asarray(images),
                    jnp.asarray(nodes), alpha)
                tot += float(metrics["loss"])
                nb += 1
                it += 1
                logger.log(it, {k: float(v) for k, v in metrics.items()})
                if cfg.val_every and it % cfg.val_every == 0:
                    vl = validate(params, alpha)
                    logger.log(it, {"val_loss": vl}, force_print=True)
                    if vl < best_val:
                        best_val = vl
                        best_params = jax.tree.map(lambda x: x, params)
                        if ckpt is not None:
                            ckpt.save("clip_finetune_best",
                                      {"params": best_params, "step": it},
                                      metadata={"val_loss": best_val})
            val_loss = validate(params, alpha)
            history["train_loss"].append(tot / max(nb, 1))
            history["val_loss"].append(val_loss)
            logger.log(it, {"epoch": epoch + 1,
                            "train_loss": tot / max(nb, 1),
                            "val_loss": val_loss, "alpha": alpha},
                       force_print=True)
            if val_loss < best_val:
                best_val = val_loss
                best_params = jax.tree.map(lambda x: x, params)
                if ckpt is not None:
                    ckpt.save("clip_finetune_best",
                              {"params": best_params, "step": it},
                              metadata={"val_loss": best_val,
                                        "epoch": epoch + 1})
    finally:
        batcher.close()
    return best_params, history
