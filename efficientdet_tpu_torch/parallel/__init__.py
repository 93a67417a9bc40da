"""Data and spatial parallelism over ``torch.distributed``: one process per
card, the collectives written out (the JAX package's ``parallel``)."""

from .sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    data_sharding,
    make_mesh,
    make_sharded_predict_fn,
    make_sharded_train_step,
    make_spatial_predict_fn,
    make_spatial_train_step,
    replicate,
    shard_batch,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "data_sharding", "make_mesh", "make_sharded_predict_fn",
    "make_sharded_train_step", "make_spatial_predict_fn", "make_spatial_train_step",
    "replicate", "shard_batch",
]
