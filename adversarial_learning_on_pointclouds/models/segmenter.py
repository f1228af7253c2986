"""PointNet dense (part-segmentation) head — the adversarial *generator*.

Reference: ``upstream:pointnet/model.py::PointNetDenseCls`` (SURVEY.md
§2.3, call stack §3.2): encoder with ``global_feat=False`` produces the
``[B, N, 1088]`` concat feature; pointwise shared MLP
1088->512->256->128 (BN+ReLU) then 128->k, ``log_softmax`` over the part
classes per point (``BASELINE.json:9`` "per-point logits").
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds.models import core
from adversarial_learning_on_pointclouds.models.encoder import (
    apply_encoder_parts, apply_encoder_parts_pair, init_encoder,
)
from adversarial_learning_on_pointclouds.ops import dispatch as ops


def init_segmenter(key: jax.Array, num_parts: int = 50,
                   feature_transform: bool = True, dtype=jnp.float32,
                   ) -> Tuple[core.Params, core.BnState]:
    keys = jax.random.split(key, 5)
    params, state = {}, {}
    params["feat"], state["feat"] = init_encoder(
        keys[0], feature_transform, dtype)
    widths = [(1088, 512), (512, 256), (256, 128)]
    for i, (c_in, c_out) in enumerate(widths, start=1):
        params[f"conv{i}"] = core.torch_linear_init(keys[i], c_in, c_out, dtype)
        params[f"bn{i}"], state[f"bn{i}"] = core.bn_init(c_out, dtype)
    params["conv4"] = core.torch_linear_init(keys[4], 128, num_parts, dtype)
    return params, state


def apply_segmenter(params: core.Params, state: core.BnState, x: jnp.ndarray,
                    train: bool,
                    ) -> Tuple[jnp.ndarray, jnp.ndarray,
                               Optional[jnp.ndarray], core.BnState]:
    """``x: [B, N, 3]`` -> ``(log_probs [B, N, k], trans, trans_feat, state)``."""
    # The reference concatenates [point_feat | tiled global] into
    # [B, N, 1088] (upstream:pointnet/model.py, SURVEY.md §3.2 "memory hot
    # spot"); here the first head layer is computed as
    # pf @ W1[:64] + (g @ W1[64:])[:, None, :] — algebraically identical,
    # but the 1088-wide concat never exists in forward OR backward.
    new_state = {}
    pf, g, trans, trans_feat, new_state["feat"] = apply_encoder_parts(
        params["feat"], state["feat"], x, train)
    logp, bns = _head(params, [state[f"bn{i}"] for i in (1, 2, 3)], pf, g,
                      train)
    new_state["bn1"], new_state["bn2"], new_state["bn3"] = bns
    return logp, trans, trans_feat, new_state


def _head(params, bn_states, pf, g, train):
    """1088->512->256->128 (BN+ReLU) -> k, log-softmax, without the concat.
    Returns ``(log_probs, [bn1, bn2, bn3])``."""
    c_pf = pf.shape[-1]
    w1 = params["conv1"]["w"]
    z = (core.matmul(pf, w1[:c_pf]) +
         core.matmul(g, w1[c_pf:])[:, None, :] + params["conv1"]["b"])
    h, bn1 = core.batch_norm(params["bn1"], bn_states[0], z, train)
    h = jnp.maximum(h, 0)
    h, bn2 = ops.linear_bn_act(params["conv2"], params["bn2"], bn_states[1],
                               h, train, "relu")
    h, bn3 = ops.linear_bn_act(params["conv3"], params["bn3"], bn_states[2],
                               h, train, "relu")
    h = ops.linear_act(params["conv4"], h, act=None)
    return jax.nn.log_softmax(h, axis=-1), [bn1, bn2, bn3]


def apply_segmenter_pair(params: core.Params, state: core.BnState,
                         x_a: jnp.ndarray, x_b: jnp.ndarray,
                         paired_conv1: bool = False,
                         ) -> Tuple[jnp.ndarray, jnp.ndarray,
                                    Optional[jnp.ndarray],
                                    Optional[jnp.ndarray], core.BnState]:
    """TRAIN-mode two-stream segmenter with cross-stream-batched T-Net fc
    heads (``--paired_heads``; see ``encoder.apply_encoder_parts_pair``).
    The head BNs keep PER-STREAM batch statistics (grouped BN — exact
    sequential semantics) and the seg head runs per-stream (state chained
    a -> b). Returns
    ``(logp_a, logp_b, trans_feat_a, trans_feat_b, new_state)``."""
    new_state = {}
    pf_a, g_a, pf_b, g_b, tf_a, tf_b, new_state["feat"] = \
        apply_encoder_parts_pair(params["feat"], state["feat"], x_a, x_b,
                                 True, paired_conv1)
    logp_a, bns_a = _head(params, [state["bn1"], state["bn2"],
                                   state["bn3"]], pf_a, g_a, True)
    logp_b, bns_b = _head(params, bns_a, pf_b, g_b, True)
    new_state["bn1"], new_state["bn2"], new_state["bn3"] = bns_b
    return logp_a, logp_b, tf_a, tf_b, new_state
