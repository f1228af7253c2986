"""T-Net spatial/feature transformers (STN3d / STNkd).

Predicts a ``k x k`` alignment matrix from a point cloud / feature map.
Architecture (reference ``upstream:pointnet/model.py::STN3d``/``STNkd``,
SURVEY.md §2.3): conv1d k->64->128->1024 (BN+ReLU each), symmetric max-pool
over points, fc 1024->512->256 (BN+ReLU), fc 256->k*k with the flattened
identity matrix added — so the transform is exactly identity at init up to
the final layer's (small, torch-default) random output.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds.models import core
from adversarial_learning_on_pointclouds.ops import dispatch as ops

_WIDTHS = (64, 128, 1024)
_FC = (512, 256)


def init_tnet(key: jax.Array, k: int, dtype=jnp.float32
              ) -> Tuple[core.Params, core.BnState]:
    keys = jax.random.split(key, 6)
    params, state = {}, {}
    c_in = k
    for i, c_out in enumerate(_WIDTHS, start=1):
        params[f"conv{i}"] = core.torch_linear_init(keys[i - 1], c_in, c_out, dtype)
        params[f"bn{i}"], state[f"bn{i}"] = core.bn_init(c_out, dtype)
        c_in = c_out
    for i, c_out in enumerate(_FC, start=1):
        params[f"fc{i}"] = core.torch_linear_init(keys[2 + i], c_in, c_out, dtype)
        params[f"bn_fc{i}"], state[f"bn_fc{i}"] = core.bn_init(c_out, dtype)
        c_in = c_out
    params["fc3"] = core.torch_linear_init(keys[5], c_in, k * k, dtype)
    return params, state


def apply_tnet(params: core.Params, state: core.BnState, x: jnp.ndarray,
               train: bool) -> Tuple[jnp.ndarray, core.BnState]:
    """``x: [B, N, k]`` -> transform ``[B, k, k]`` (+ updated BN state)."""
    k = x.shape[-1]  # fc3 emits k*k; k == input channel count
    h, conv_state = _pooled_trunk(params, state, x, train)
    out, fc_state = _fc_head_apply(params, state, h, train)
    iden = jnp.eye(k, dtype=out.dtype).reshape(-1)
    return (out + iden).reshape(-1, k, k), {**conv_state, **fc_state}


def apply_tnet_pair(params: core.Params, state: core.BnState,
                    x_a: jnp.ndarray, x_b: jnp.ndarray, train: bool,
                    paired_conv1: bool = False,
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, core.BnState]:
    """Two same-shape streams with the fc head matmuls BATCHED across
    them — per-stream BN statistics (reference semantics preserved).

    The conv trunks (and their BN batch statistics) stay per-stream with
    the EMA state chained a -> b — identical numerics to two sequential
    ``apply_tnet`` calls. The [B, 1024]-row fc head runs its matmuls
    once on the stacked ``[2B, 1024]`` pool (``--paired_heads``); its
    batch-axis BNs compute statistics PER STREAM over the row blocks with
    the running-stat EMA chained a -> b (``core.batch_norm_grouped``) —
    the exact statistics of two sequential calls. ``paired_conv1``
    additionally batches the conv1 matmul across the streams."""
    if paired_conv1 and train:
        h_a, h_b, st_ab = _pooled_trunk_pair_conv1(params, state, x_a, x_b)
        mid = dict(state)
        mid.update(st_ab)
    else:
        h_a, st_a = _pooled_trunk(params, state, x_a, train)
        mid = dict(state)
        mid.update(st_a)
        h_b, st_b = _pooled_trunk(params, mid, x_b, train)
        st_ab = {**st_a, **st_b}
    h = jnp.concatenate([h_a, h_b], axis=0)
    out, fc_state = _fc_head_apply(params, mid, h, train, streams=2)
    k = x_a.shape[-1]
    iden = jnp.eye(k, dtype=out.dtype).reshape(-1)
    trans = (out + iden).reshape(-1, k, k)
    b = x_a.shape[0]
    return trans[:b], trans[b:], {**st_ab, **fc_state}


def _trunk_tail(params, s_bn2, s_bn3, h1, train):
    """conv2+BN2+ReLU -> conv3+BN3 -> max-pool -> ReLU (the reference
    applies ReLU before the pool; ReLU is monotone, so
    ``max(relu(y)) == relu(max(y))``)."""
    h, bn2 = ops.linear_bn_act(params["conv2"], params["bn2"], s_bn2, h1,
                               train=train, act="relu")
    g, bn3 = ops.linear_bn_maxpool(params["conv3"], params["bn3"], s_bn3, h,
                                   train)
    return jnp.maximum(g, 0), bn2, bn3


def _pooled_trunk(params: core.Params, state: core.BnState, x: jnp.ndarray,
                  train: bool) -> Tuple[jnp.ndarray, core.BnState]:
    """conv1..conv3 (+BNs) + symmetric max-pool -> ``[B, 1024]``."""
    new_state = {}
    h1, new_state["bn1"] = ops.linear_bn_act(
        params["conv1"], params["bn1"], state["bn1"], x, train=train,
        act="relu")
    h, new_state["bn2"], new_state["bn3"] = _trunk_tail(
        params, state["bn2"], state["bn3"], h1, train)
    return h, new_state


def _pooled_trunk_pair_conv1(params: core.Params, state: core.BnState,
                             x_a: jnp.ndarray, x_b: jnp.ndarray,
                             ) -> Tuple[jnp.ndarray, jnp.ndarray,
                                        core.BnState]:
    """Train-mode two-stream trunk with ONLY conv1 batched across the
    streams (``--paired_conv1``): one ``[2B, N, C]`` conv1 matmul with
    per-stream grouped BN1 statistics (EMA chained a -> b — the exact
    statistics of two sequential calls), then the per-stream trunk."""
    new_state = {}
    h1_a, h1_b, new_state["bn1"] = ops.linear_bn_act_pair(
        params["conv1"], params["bn1"], state["bn1"], x_a, x_b, "relu")
    h_a, bn2_a, bn3_a = _trunk_tail(params, state["bn2"], state["bn3"],
                                    h1_a, True)
    h_b, new_state["bn2"], new_state["bn3"] = _trunk_tail(
        params, bn2_a, bn3_a, h1_b, True)
    return h_a, h_b, new_state


def _fc_head_apply(params: core.Params, state: core.BnState,
                   h: jnp.ndarray, train: bool, streams: int = 1,
                   ) -> Tuple[jnp.ndarray, core.BnState]:
    """fc1+BN+ReLU -> fc2+BN+ReLU -> fc3 on pooled ``[B, 1024]`` rows
    (identity bias added by the caller).

    ``streams>1`` (the ``--paired_heads`` path): ``h`` is ``streams``
    stacked per-stream pools ``[S*B, 1024]``; the matmuls run batched
    but every batch-axis BN computes PER-STREAM statistics with the EMA
    chained stream 0 -> S-1 — exactly the statistics of sequential
    per-stream calls (``core.batch_norm_grouped``)."""
    new_state = {}
    if train and streams > 1:
        for i in range(1, 3):
            z = core.dense(params[f"fc{i}"], h)
            h, new_state[f"bn_fc{i}"] = core.batch_norm_grouped(
                params[f"bn_fc{i}"], state[f"bn_fc{i}"], z, True, streams)
            h = jnp.maximum(h, 0)
    else:
        for i in range(1, 3):
            h, new_state[f"bn_fc{i}"] = ops.linear_bn_act(
                params[f"fc{i}"], params[f"bn_fc{i}"], state[f"bn_fc{i}"], h,
                train=train, act="relu")
    return core.dense(params["fc3"], h), new_state
