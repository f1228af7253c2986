"""Config 3 trainer: ShapeNet-part segmentation (``BASELINE.json:9``).

Rebuild of ``upstream:train_segmentation.py`` (SURVEY.md §2.6): per-point
NLL on the 50 part classes (+ ortho regularizer), Adam + StepLR, per-epoch
instance mIoU with the category-restricted protocol
(``utils/metrics.py``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds import losses
from adversarial_learning_on_pointclouds.configs import SegmentConfig
from adversarial_learning_on_pointclouds.data import augment
from adversarial_learning_on_pointclouds.models import (
    apply_segmenter, init_segmenter,
)
from adversarial_learning_on_pointclouds.ops import dispatch
from adversarial_learning_on_pointclouds.train import state as state_lib
from adversarial_learning_on_pointclouds.train.classify import FT_REG_WEIGHT
from adversarial_learning_on_pointclouds.utils import metrics


def create_state(cfg: SegmentConfig, steps_per_epoch: int,
                 rng: Optional[jax.Array] = None) -> state_lib.TrainState:
    rng = jax.random.PRNGKey(cfg.seed) if rng is None else rng
    k_init, k_run = jax.random.split(rng)
    params, bn_state = init_segmenter(
        k_init, cfg.num_parts, cfg.feature_transform,
        dtype=jnp.dtype(cfg.dtype))
    tx = make_tx(cfg, steps_per_epoch)
    return state_lib.TrainState(
        params=params, bn_state=bn_state, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), rng=k_run)


def make_tx(cfg: SegmentConfig, steps_per_epoch: int):
    return state_lib.make_optimizer(
        cfg.lr, cfg.beta1, cfg.beta2, cfg.lr_step, cfg.lr_gamma,
        steps_per_epoch, optimizer=cfg.optimizer,
        lr_schedule=cfg.lr_schedule,
        total_steps=cfg.epochs * steps_per_epoch,
        poly_power=cfg.poly_power)


def loss_fn(params, bn_state, points, part_labels, cfg: SegmentConfig,
            ) -> Tuple[jnp.ndarray, Tuple]:
    logp, _, trans_feat, new_bn = apply_segmenter(
        params, bn_state, points, train=True)
    loss = losses.nll_loss(logp, part_labels)
    if cfg.feature_transform:
        loss = loss + FT_REG_WEIGHT * losses.orthogonality_reg(trans_feat)
    acc = jnp.mean(jnp.argmax(logp, -1) == part_labels)
    return loss, (new_bn, acc)


def _train_step_impl(state, points, part_labels, cfg: SegmentConfig, tx):
    rng, k_aug = jax.random.split(state.rng)
    points, part_labels = augment.chain_from_cfg(k_aug, cfg, points,
                                                 part_labels)
    (loss, (new_bn, acc)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(state.params, state.bn_state, points,
                               part_labels, cfg)
    updates, new_opt = tx.update(grads, state.opt_state, state.params)
    new_params = jax.tree_util.tree_map(
        lambda p, u: p + u, state.params, updates)
    return state_lib.TrainState(new_params, new_bn, new_opt,
                                state.step + 1, rng), \
        {"loss": loss, "acc": acc}


@functools.partial(jax.jit, static_argnames=("cfg", "tx", "paths"))
def _train_step(state, points, part_labels, *, cfg: SegmentConfig, tx,
                paths):
    with dispatch.path_context(paths):
        return _train_step_impl(state, points, part_labels, cfg, tx)


def train_step(state: state_lib.TrainState, points: jnp.ndarray,
               part_labels: jnp.ndarray, *, cfg: SegmentConfig, tx,
               ) -> Tuple[state_lib.TrainState, Dict[str, jnp.ndarray]]:
    """One fused update; per-point labels ride the on-device resample
    gather. Pallas/bf16 path flags are jit-cache-keyed (see classify)."""
    return _train_step(state, points, part_labels, cfg=cfg, tx=tx,
                       paths=dispatch.current_paths())


# Device-resident-pool variants (see state_lib.gather_step_fns).
train_step_gather, train_steps_scan_gather, train_steps_scan = \
    state_lib.gather_step_fns(_train_step_impl)


@functools.partial(jax.jit, static_argnames=("paths",))
def _eval_step(params, bn_state, points, part_labels, categories, paths):
    with dispatch.path_context(paths):
        logp, _, _, _ = apply_segmenter(params, bn_state, points,
                                        train=False)
        pred = jnp.argmax(logp, -1)
        ious = metrics.shape_ious_device(pred, part_labels, categories)
        return {"pred": pred, "ious": ious,
                "correct": jnp.sum(pred == part_labels)}


def eval_step(params, bn_state, points, part_labels, categories,
              ) -> Dict[str, jnp.ndarray]:
    """Eval forward + on-device per-shape IoU (category-restricted)."""
    return _eval_step(params, bn_state, points, part_labels, categories,
                      dispatch.current_paths())


def eval_scan_inner(params, bn_state, pool_x, pool_y, pool_c, idx):
    """Trace-level whole-test-pass scan (no jit wrapper): used by
    ``eval_scan`` below and inlined into fused epoch programs
    (``adversarial.epoch_program``) so train + eval share one launch."""
    def body(_, ib):
        x = jnp.take(pool_x, ib, axis=0)
        y = jnp.take(pool_y, ib, axis=0)
        c = jnp.take(pool_c, ib, axis=0)
        logp, _, _, _ = apply_segmenter(params, bn_state, x, train=False)
        pred = jnp.argmax(logp, -1)
        return None, {"correct": jnp.sum(pred == y, axis=-1),
                      "ious": metrics.shape_ious_device(pred, y, c)}

    _, outs = jax.lax.scan(body, None, idx)
    return outs


@functools.partial(jax.jit, static_argnames=("paths",))
def _eval_scan(params, bn_state, pool_x, pool_y, pool_c, idx, paths):
    with dispatch.path_context(paths):
        return eval_scan_inner(params, bn_state, pool_x, pool_y, pool_c,
                               idx)


def eval_scan(params, bn_state, pool_x, pool_y, pool_c,
              idx) -> Dict[str, jnp.ndarray]:
    """The WHOLE test pass as one compiled launch: ``idx [S, B]`` selects
    each batch from device-resident pools (gather in-program), the scan
    body runs the eval forward + on-device category-restricted IoU and
    per-shape correct-point counts. One dispatch + one readback per eval
    instead of one per batch, and the readback is two [S, B] vectors —
    the [S, B, N] prediction tensor (4 MB at the 512x2048 test split)
    never leaves the device; every metric the protocol needs (instance
    mIoU, point accuracy, per-category table) derives from per-shape
    reductions."""
    return _eval_scan(params, bn_state, pool_x, pool_y, pool_c, idx,
                      dispatch.current_paths())


# Fused whole-epoch program: spe train steps + this eval scan in ONE
# launch (--fused_epoch; see state_lib.epoch_program_fns).
epoch_program = state_lib.epoch_program_fns(_train_step_impl,
                                            eval_scan_inner)
