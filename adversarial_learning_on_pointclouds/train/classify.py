"""Config 1-2 trainer: ModelNet40 classification (``BASELINE.json:7-8``).

Rebuild of ``upstream:train_classification.py`` (SURVEY.md §2.6, call
stack §3.1): NLL loss (+ 0.001 * orthogonality regularizer when
``feature_transform``), Adam + StepLR, per-epoch test accuracy. The whole
per-batch body — on-device augmentation, forward, backward, update —
compiles to one jitted step.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds import losses
from adversarial_learning_on_pointclouds.configs import ClassifyConfig
from adversarial_learning_on_pointclouds.data import augment
from adversarial_learning_on_pointclouds.models import (
    apply_classifier, init_classifier,
)
from adversarial_learning_on_pointclouds.ops import dispatch
from adversarial_learning_on_pointclouds.train import state as state_lib

FT_REG_WEIGHT = 0.001  # reference's feature-transform regularizer weight


def create_state(cfg: ClassifyConfig, steps_per_epoch: int,
                 rng: Optional[jax.Array] = None) -> state_lib.TrainState:
    rng = jax.random.PRNGKey(cfg.seed) if rng is None else rng
    k_init, k_run = jax.random.split(rng)
    params, bn_state = init_classifier(
        k_init, cfg.num_classes, cfg.feature_transform,
        dtype=jnp.dtype(cfg.dtype))
    tx = make_tx(cfg, steps_per_epoch)
    return state_lib.TrainState(
        params=params, bn_state=bn_state, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), rng=k_run)


def make_tx(cfg: ClassifyConfig, steps_per_epoch: int):
    return state_lib.make_optimizer(
        cfg.lr, cfg.beta1, cfg.beta2, cfg.lr_step, cfg.lr_gamma,
        steps_per_epoch, optimizer=cfg.optimizer,
        lr_schedule=cfg.lr_schedule,
        total_steps=cfg.epochs * steps_per_epoch,
        poly_power=cfg.poly_power)


def loss_fn(params, bn_state, points, labels, rng, cfg: ClassifyConfig,
            ) -> Tuple[jnp.ndarray, Tuple]:
    logp, _, trans_feat, new_bn = apply_classifier(
        params, bn_state, points, train=True, rng=rng,
        dropout_rate=cfg.dropout)
    loss = losses.nll_loss(logp, labels)
    if cfg.feature_transform:
        loss = loss + FT_REG_WEIGHT * losses.orthogonality_reg(trans_feat)
    acc = jnp.mean(jnp.argmax(logp, -1) == labels)
    return loss, (new_bn, acc)


def _train_step_impl(state, points, labels, cfg: ClassifyConfig, tx):
    rng, k_aug, k_drop = jax.random.split(state.rng, 3)
    points = augment.chain_from_cfg(k_aug, cfg, points)
    (loss, (new_bn, acc)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(state.params, state.bn_state, points,
                               labels, k_drop, cfg)
    updates, new_opt = tx.update(grads, state.opt_state, state.params)
    new_params = jax.tree_util.tree_map(
        lambda p, u: p + u, state.params, updates)
    new_state = state_lib.TrainState(
        params=new_params, bn_state=new_bn, opt_state=new_opt,
        step=state.step + 1, rng=rng)
    return new_state, {"loss": loss, "acc": acc}


@functools.partial(jax.jit, static_argnames=("cfg", "tx", "paths"))
def _train_step(state, points, labels, *, cfg: ClassifyConfig, tx, paths):
    with dispatch.path_context(paths):
        return _train_step_impl(state, points, labels, cfg, tx)


def train_step(state: state_lib.TrainState, points: jnp.ndarray,
               labels: jnp.ndarray, *, cfg: ClassifyConfig, tx,
               ) -> Tuple[state_lib.TrainState, Dict[str, jnp.ndarray]]:
    """One fused update: preprocess chain -> fwd -> bwd -> Adam.
    ``points [B,N_src,3]`` (resampled on device to ``cfg.num_points``).

    The trace-time Pallas/bf16 path flags are captured here and threaded
    into the jit cache key (``dispatch.current_paths``), so toggling the
    contexts between calls re-traces rather than silently reusing the
    previously compiled path."""
    return _train_step(state, points, labels, cfg=cfg, tx=tx,
                       paths=dispatch.current_paths())


# Device-resident-pool variants: [B] / [K, B] int32 index transfers, the
# batch gather on device (see state_lib.gather_step_fns).
train_step_gather, train_steps_scan_gather, train_steps_scan = \
    state_lib.gather_step_fns(_train_step_impl)


@functools.partial(jax.jit, static_argnames=("paths",))
def _eval_step(params, bn_state, points, labels, paths):
    with dispatch.path_context(paths):
        logp, _, _, _ = apply_classifier(params, bn_state, points,
                                         train=False)
        pred = jnp.argmax(logp, -1)
        return {"log_probs": logp, "pred": pred,
                "correct": jnp.sum(pred == labels)}


def eval_step(params, bn_state, points, labels) -> Dict[str, jnp.ndarray]:
    """Eval-mode forward (BN running stats, no dropout) + correctness counts."""
    return _eval_step(params, bn_state, points, labels,
                      dispatch.current_paths())


def eval_scan_inner(params, bn_state, pool_x, idx):
    """Trace-level whole-test-pass scan (no jit wrapper) — shared by
    ``eval_scan`` and the fused epoch programs
    (``state_lib.epoch_program_fns``)."""
    def body(_, ib):
        x = jnp.take(pool_x, ib, axis=0)
        logp, _, _, _ = apply_classifier(params, bn_state, x,
                                         train=False)
        return None, jnp.argmax(logp, -1)

    _, preds = jax.lax.scan(body, None, idx)
    return preds


@functools.partial(jax.jit, static_argnames=("paths",))
def _eval_scan(params, bn_state, pool_x, idx, paths):
    with dispatch.path_context(paths):
        return eval_scan_inner(params, bn_state, pool_x, idx)


def eval_scan(params, bn_state, pool_x, idx) -> jnp.ndarray:
    """The whole test pass as one compiled launch (see segment.eval_scan):
    returns predicted class ids ``[S, B]`` for ``idx [S, B]`` rows of the
    device-resident test pool."""
    return _eval_scan(params, bn_state, pool_x, idx,
                      dispatch.current_paths())


# Fused whole-epoch program: spe train steps + this eval scan in ONE
# launch (--fused_epoch; see state_lib.epoch_program_fns).
epoch_program = state_lib.epoch_program_fns(_train_step_impl,
                                            eval_scan_inner)
