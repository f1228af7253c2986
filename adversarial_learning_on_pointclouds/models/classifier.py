"""PointNet classification head (``PointNetCls`` in the reference).

Reference: ``upstream:pointnet/model.py::PointNetCls`` (SURVEY.md §2.3):
fc 1024->512 (BN+ReLU), fc 512->256 with dropout(0.3) applied *between*
the linear and its BatchNorm (the known pointnet.pytorch ordering:
``relu(bn2(dropout(fc2(x))))``), fc 256->k, ``log_softmax``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds.models import core
from adversarial_learning_on_pointclouds.models.encoder import (
    apply_encoder, init_encoder,
)
from adversarial_learning_on_pointclouds.ops import dispatch as ops


def init_classifier(key: jax.Array, num_classes: int = 40,
                    feature_transform: bool = False, dtype=jnp.float32,
                    ) -> Tuple[core.Params, core.BnState]:
    keys = jax.random.split(key, 4)
    params, state = {}, {}
    params["feat"], state["feat"] = init_encoder(
        keys[0], feature_transform, dtype)
    params["fc1"] = core.torch_linear_init(keys[1], 1024, 512, dtype)
    params["bn1"], state["bn1"] = core.bn_init(512, dtype)
    params["fc2"] = core.torch_linear_init(keys[2], 512, 256, dtype)
    params["bn2"], state["bn2"] = core.bn_init(256, dtype)
    params["fc3"] = core.torch_linear_init(keys[3], 256, num_classes, dtype)
    return params, state


def apply_classifier(params: core.Params, state: core.BnState,
                     x: jnp.ndarray, train: bool,
                     rng: Optional[jax.Array] = None, dropout_rate: float = 0.3,
                     ) -> Tuple[jnp.ndarray, jnp.ndarray,
                                Optional[jnp.ndarray], core.BnState]:
    """``x: [B, N, 3]`` -> ``(log_probs [B, k], trans, trans_feat, state)``."""
    new_state = {}
    h, trans, trans_feat, new_state["feat"] = apply_encoder(
        params["feat"], state["feat"], x, train, global_feat=True)
    h, new_state["bn1"] = ops.linear_bn_act(
        params["fc1"], params["bn1"], state["bn1"], h, train, "relu")
    # pointnet.pytorch ordering: relu(bn2(dropout(fc2(x))))
    h = core.dense(params["fc2"], h)
    if train:
        h = core.dropout(h, dropout_rate, rng, train)
    h, new_state["bn2"] = core.batch_norm(params["bn2"], state["bn2"], h, train)
    h = jnp.maximum(h, 0)
    h = core.dense(params["fc3"], h)
    return jax.nn.log_softmax(h, axis=-1), trans, trans_feat, new_state
