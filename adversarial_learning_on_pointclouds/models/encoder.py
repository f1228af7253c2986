"""PointNet encoder trunk (``PointNetfeat`` in the reference).

Reference: ``upstream:pointnet/model.py::PointNetfeat`` (SURVEY.md §2.3,
call stack §3.2). Pipeline on ``x: [B, N, 3]``:

1. STN3d predicts ``T in R^{3x3}``; apply ``x <- x @ T``.
2. Shared MLP 3->64 (BN+ReLU).
3. Optionally STNkd predicts ``T64``; apply to the 64-d features.
4. Shared MLP 64->128 (BN+ReLU), 128->1024 (BN, **no ReLU** — the
   reference applies ``bn3(conv3(x))`` and pools directly).
5. Symmetric max-pool over the point axis -> 1024-d global feature.

``global_feat=False`` (segmentation) concatenates the 64-d per-point
feature with the tiled global feature -> ``[B, N, 1088]``. The conv3 +
BN + max-pool exit goes through ``ops.linear_bn_maxpool``, which on a GPU
never materializes ``[B, N, 1024]`` (``ops/kernels/trunk_pool.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds.models import core
from adversarial_learning_on_pointclouds.models.tnet import apply_tnet, init_tnet
from adversarial_learning_on_pointclouds.ops import dispatch as ops


def init_encoder(key: jax.Array, feature_transform: bool = False,
                 dtype=jnp.float32) -> Tuple[core.Params, core.BnState]:
    keys = jax.random.split(key, 5)
    params, state = {}, {}
    params["stn"], state["stn"] = init_tnet(keys[0], k=3, dtype=dtype)
    widths = [(3, 64), (64, 128), (128, 1024)]
    for i, (c_in, c_out) in enumerate(widths, start=1):
        params[f"conv{i}"] = core.torch_linear_init(keys[i], c_in, c_out, dtype)
        params[f"bn{i}"], state[f"bn{i}"] = core.bn_init(c_out, dtype)
    if feature_transform:
        params["fstn"], state["fstn"] = init_tnet(keys[4], k=64, dtype=dtype)
    return params, state


def apply_encoder_parts(params: core.Params, state: core.BnState,
                        x: jnp.ndarray, train: bool,
                        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                                   Optional[jnp.ndarray], core.BnState]:
    """Returns ``(point_feat [B,N,64], global [B,1024], trans, trans_feat,
    new_state)`` — the raw pieces, letting callers (the segmenter head)
    avoid materializing the 1088-d concat."""
    new_state = {}
    trans, new_state["stn"] = apply_tnet(params["stn"], state["stn"], x, train)
    x = ops.batched_transform(x, trans)
    x, new_state["bn1"] = ops.linear_bn_act(
        params["conv1"], params["bn1"], state["bn1"], x, train, "relu")

    trans_feat = None
    if "fstn" in params:  # feature_transform was enabled at init
        trans_feat, new_state["fstn"] = apply_tnet(
            params["fstn"], state["fstn"], x, train)
        x = ops.batched_transform(x, trans_feat)

    point_feat = x  # [B, N, 64]
    global_feature, new_state["bn2"], new_state["bn3"] = _trunk_tail(
        params, state["bn2"], state["bn3"], point_feat, train)
    return point_feat, global_feature, trans, trans_feat, new_state


def _trunk_tail(params, s_bn2, s_bn3, pf, train):
    """conv2 (BN+ReLU) -> conv3 (BN, no ReLU) -> max-pool -> ``[B, 1024]``."""
    h, bn2 = ops.linear_bn_act(params["conv2"], params["bn2"], s_bn2, pf,
                               train, "relu")
    g, bn3 = ops.linear_bn_maxpool(params["conv3"], params["bn3"], s_bn3, h,
                                   train)
    return g, bn2, bn3


def apply_encoder_parts_pair(params: core.Params, state: core.BnState,
                             x_a: jnp.ndarray, x_b: jnp.ndarray,
                             train: bool, paired_conv1: bool = False):
    """Two-stream encoder with the T-Net fc heads batched across streams
    (``tnet.apply_tnet_pair``; adversarial ``--paired_heads``). The conv
    layers and trunks stay per-stream — BN batch statistics are identical
    to two sequential calls, state chained a -> b. Returns
    ``(pf_a, g_a, pf_b, g_b, trans_feat_a, trans_feat_b, new_state)``."""
    from adversarial_learning_on_pointclouds.models.tnet import (
        apply_tnet_pair,
    )

    new_state = {}
    t_a, t_b, new_state["stn"] = apply_tnet_pair(
        params["stn"], state["stn"], x_a, x_b, train, paired_conv1)
    x_a = ops.batched_transform(x_a, t_a)
    x_b = ops.batched_transform(x_b, t_b)
    if paired_conv1 and train:
        x_a, x_b, new_state["bn1"] = ops.linear_bn_act_pair(
            params["conv1"], params["bn1"], state["bn1"], x_a, x_b, "relu")
    else:
        x_a, bn1_a = ops.linear_bn_act(
            params["conv1"], params["bn1"], state["bn1"], x_a, train,
            "relu")
        x_b, new_state["bn1"] = ops.linear_bn_act(
            params["conv1"], params["bn1"], bn1_a, x_b, train, "relu")

    tf_a = tf_b = None
    if "fstn" in params:
        tf_a, tf_b, new_state["fstn"] = apply_tnet_pair(
            params["fstn"], state["fstn"], x_a, x_b, train, paired_conv1)
        x_a = ops.batched_transform(x_a, tf_a)
        x_b = ops.batched_transform(x_b, tf_b)

    g_a, bn2_a, bn3_a = _trunk_tail(params, state["bn2"], state["bn3"], x_a,
                                    train)
    g_b, new_state["bn2"], new_state["bn3"] = _trunk_tail(
        params, bn2_a, bn3_a, x_b, train)
    return x_a, g_a, x_b, g_b, tf_a, tf_b, new_state


def apply_encoder(params: core.Params, state: core.BnState, x: jnp.ndarray,
                  train: bool, global_feat: bool = True,
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray],
                             core.BnState]:
    """Reference-shaped API: ``(feature, trans, trans_feat, new_state)``.

    ``feature`` is ``[B, 1024]`` when ``global_feat`` else the
    ``[B, N, 1088]`` per-point concat (``upstream:pointnet/model.py::
    PointNetfeat``). The segmenter uses ``apply_encoder_parts`` directly
    to skip the concat.
    """
    point_feat, g, trans, trans_feat, new_state = apply_encoder_parts(
        params, state, x, train)
    if global_feat:
        return g, trans, trans_feat, new_state
    b, n = point_feat.shape[0], point_feat.shape[1]
    tiled = jnp.broadcast_to(g[:, None, :], (b, n, g.shape[-1]))
    feat = jnp.concatenate([point_feat, tiled], axis=-1)  # [B, N, 1088]
    return feat, trans, trans_feat, new_state
