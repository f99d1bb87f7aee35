"""Device mesh + sharding helpers.  The hyperbolic trainer's sharded step
(``sharded_train``, which needs Flax) is imported on first use."""

import importlib

from .mesh import (  # noqa: F401
    data_parallel_sharding,
    encode_sharded,
    label_table_sharding,
    make_mesh,
    shard_batch,
)

_LAZY = ("make_hyp_mesh", "make_sharded_train_step", "shard_hyp_state")


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(".sharded_train", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
