"""Pod-scale sharded training for the hyperbolic retrieval model.

The reference is single-GPU (SURVEY §2: no distribution anywhere); this
module is the framework's multi-chip training path for ``train_hyp``:

* 2-D mesh ``(data, model)``,
* batch index arrays sharded over ``data`` (pure data parallelism — the
  gradient psum is inserted by XLA),
* the hyperbolic label table — the one parameter that grows with corpus
  size (LABEL_NUM ≈ patents + CPCs; 14k for the 2018 corpus, reference
  train.py:3878, linear in patents) — row-sharded over ``model``; gathers
  of positive/negative label rows become XLA all-gathers,
* encoder params replicated (they are small: ~2 MobiusDense layers).

Validated on the virtual CPU mesh in tests: the sharded step's loss equals
the single-device step's loss bit-for-bit given identical inputs, and the
updated label table keeps its sharding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.hyperbolic import HyperbolicEmbeddingModel
from ..train.train_hyp import make_train_step
from ..utils.config import HypTrainConfig


def make_hyp_mesh(n_devices: int | None = None, model_dim: int = 1,
                  devices=None) -> Mesh:
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % model_dim:
        raise ValueError(f"{n} devices not divisible by model_dim={model_dim}")
    return Mesh(np.asarray(devs).reshape(n // model_dim, model_dim),
                ("data", "model"))


def pad_label_table(params, opt_state, model_size: int):
    """Zero-pad every ``label_emb`` leaf (params AND its optimizer moments)
    along axis 0 to the next multiple of ``model_size`` so the table can be
    genuinely row-sharded — replication is never the fallback.

    Padded rows are inert: no batch index ever gathers them, and the
    dist0-band regularizer masks them via ``num_real_labels``
    (train_hyp.make_train_step), so their gradient is exactly zero and they
    stay at the origin.  Returns (params, opt_state, real_rows, padded_rows).
    """
    real = None

    def pad(path, leaf):
        nonlocal real
        ks = jax.tree_util.keystr(path)
        if "label_emb" in ks and getattr(leaf, "ndim", 0) >= 1:
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
        raise ValueError("no label_emb leaf found in params")
    padded = -(-real // model_size) * model_size
    return params, opt_state, real, padded


def shard_hyp_state(mesh: Mesh, params, opt_state):
    """Place params/opt state on the mesh: label_emb rows over ``model``,
    everything else replicated.  Optimizer moments follow their params.

    The label table MUST divide the model axis — call ``pad_label_table``
    first for arbitrary row counts.  (Round 1 silently replicated
    non-divisible tables, defeating the purpose of the model axis for the
    one parameter that grows with corpus size.)
    """

    model_size = mesh.shape["model"]

    def spec_for(path, leaf):
        ks = jax.tree_util.keystr(path)
        if "label_emb" in ks and getattr(leaf, "ndim", 0) >= 1:
            if leaf.shape[0] % model_size:
                raise ValueError(
                    f"label table rows ({leaf.shape[0]}) must divide the "
                    f"model axis ({model_size}); use pad_label_table first")
            return NamedSharding(mesh, P("model"))
        return NamedSharding(mesh, P())

    params = jax.device_put(
        params, jax.tree_util.tree_map_with_path(spec_for, params))
    opt_state = jax.device_put(
        opt_state, jax.tree_util.tree_map_with_path(spec_for, opt_state))
    return params, opt_state


def make_sharded_train_step(mesh: Mesh, model: HyperbolicEmbeddingModel,
                            optimizer, cfg: HypTrainConfig,
                            num_real_labels: int | None = None):
    """The train_hyp step with explicit input shardings over the mesh.

    Batch arrays are sharded over ``data``; the figure feature matrix — the
    other array that grows with corpus size — is ROW-SHARDED over ``data``
    (GSPMD turns the batch gather into collective traffic instead of
    keeping N full copies in device memory); implication/exclusion pair lists are
    small and stay replicated; XLA inserts the gradient psum over ``data``
    and the label-row all-gathers over ``model``.

    ``num_real_labels``: pass the pre-padding row count when the label table
    was padded with ``pad_label_table`` so the regularizer masks the padding.
    """
    base_step, _ = make_train_step(model, optimizer, cfg,
                                   num_real_labels=num_real_labels)
    data_sharding = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    def place_batch(batch_arrays):
        return tuple(jax.device_put(jnp.asarray(a), data_sharding)
                     for a in batch_arrays)

    def place_static(x_figures, implication, exclusion):
        x = jnp.asarray(x_figures)
        # pad rows to the data axis, then row-shard; batch indices always
        # point below the real row count so padding is never gathered
        data_size = mesh.shape["data"]
        target = -(-x.shape[0] // data_size) * data_size
        if target != x.shape[0]:
            x = jnp.pad(x, ((0, target - x.shape[0]), (0, 0)))
        return (jax.device_put(x, NamedSharding(mesh, P("data"))),
                jax.device_put(jnp.asarray(implication), repl),
                jax.device_put(jnp.asarray(exclusion), repl))

    return base_step, place_batch, place_static
