"""Device mesh construction and sharding rules.

The reference is strictly single-device (SURVEY §2: no DP/TP/PP anywhere);
scaling here is a first-class new component.  The framework uses at most a
2-D mesh:

* ``data``  — batch-sharded image encoding / training (pjit data parallel);
  also the gallery axis of the sharded retrieval index (rows of the index
  live on different devices, candidates merge in one all-gather —
  retrieval/index.py).
* ``model`` — tensor-parallel axis for the ViT MLC/attention blocks and the
  hyperbolic label table when either outgrows one device's memory.

Helpers return ``NamedSharding`` rules for each logical array family, and
``encode_sharded`` wraps an encoder apply in pjit with batch sharding.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("data", "model"),
              devices: Sequence[jax.Device] | None = None) -> Mesh:
    """Build a mesh over the available devices.

    Default: all devices on the ``data`` axis, ``model`` size 1 — the right
    layout for encode/retrieval workloads (embarrassingly batch-parallel,
    collectives only for the top-k merge).
    """
    devs = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devs), 1)
    arr = np.asarray(devs).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names[:arr.ndim]))


def data_parallel_sharding(mesh: Mesh) -> dict[str, NamedSharding]:
    """Sharding rules for the encode path: batch over ``data``, params
    replicated."""
    return {
        "batch": NamedSharding(mesh, P("data")),
        "params": NamedSharding(mesh, P()),
        "gallery": NamedSharding(mesh, P("data")),
    }


def label_table_sharding(mesh: Mesh) -> NamedSharding:
    """The hyperbolic label table sharded over ``model`` rows (it is the one
    parameter that scales with corpus size: LABEL_NUM ≈ 14k for 2018 data,
    reference train.py:3878, but grows linearly with patents)."""
    return NamedSharding(mesh, P("model"))


def encode_sharded(mesh: Mesh, apply_fn, params, batch_axis: str = "data"):
    """jit an encoder apply with the batch sharded over ``mesh[batch_axis]``
    and params replicated: XLA inserts the all-gathers.

    Params are jit ARGUMENTS (device-resident, replicated), never closure
    constants — closed-over weights get baked into the HLO, which bloats the
    program and overflows remote-compile payload limits.
    """
    batch_sharding = NamedSharding(mesh, P(batch_axis))
    out_sharding = NamedSharding(mesh, P(batch_axis))
    params = jax.device_put(params, NamedSharding(mesh, P()))

    @jax.jit
    def fn(p, batch):
        batch = jax.lax.with_sharding_constraint(batch, batch_sharding)
        out = apply_fn(p, batch)
        return jax.lax.with_sharding_constraint(out, out_sharding)

    return lambda batch: fn(params, batch)


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """Place a host batch onto the mesh, sharded along its leading axis."""
    return jax.device_put(batch, NamedSharding(mesh, P(axis)))
