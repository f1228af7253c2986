"""Parallelism: device mesh construction and sharding specs (SPMD)."""

from adversarial_learning_on_pointclouds.parallel.mesh import (  # noqa: F401
    make_mesh, make_multihost_mesh, batch_sharding, point_sharded_eval,
    point_sharded_train_step, point_sharding, replicated, shard_batch,
)
