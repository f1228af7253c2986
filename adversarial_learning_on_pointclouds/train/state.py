"""Train state pytrees and optimizer construction.

The reference uses ``torch.optim.Adam(lr=1e-3, betas=(0.9, 0.999))`` with
``StepLR(step_size=20, gamma=0.5)`` stepped per epoch
(``upstream:train_*.py``; SURVEY.md §2.6). Here the schedule is expressed
per optimizer step (staircase decay every ``lr_step * steps_per_epoch``
steps), which is equivalent for full epochs.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import jax
import optax


class TrainState(NamedTuple):
    """Single-network train state (configs 1-3, 5)."""

    params: Any
    bn_state: Any
    opt_state: Any
    step: jax.Array  # int32 scalar
    rng: jax.Array   # threaded PRNG key


class GANTrainState(NamedTuple):
    """Generator + discriminator train state (config 4)."""

    g_params: Any
    g_bn_state: Any
    g_opt_state: Any
    d_params: Any
    d_opt_state: Any
    step: jax.Array
    rng: jax.Array


def make_optimizer(lr: float, beta1: float, beta2: float,
                   lr_step_epochs: int, lr_gamma: float,
                   steps_per_epoch: int, *,
                   optimizer: str = "adam", lr_schedule: str = "step",
                   total_steps: int = 0, poly_power: float = 0.9,
                   momentum: float = 0.9,
                   ) -> optax.GradientTransformation:
    """Optimizer + schedule factory.

    Defaults reproduce the reference lineage: Adam + StepLR-equivalent
    staircase decay. The Hung et al. arXiv:1802.07934 originals (which
    the reference adapts) instead use SGD(momentum 0.9) for G and Adam
    for D, both with POLY decay ``lr * (1 - step/total)^0.9`` — exposed
    via ``optimizer='sgd'`` / ``lr_schedule='poly'`` since the reference
    mount is empty and its exact choice is [C]-tier (SURVEY.md §2.6;
    VERDICT round 1, missing #1).
    """
    if lr_schedule == "poly" and total_steps > 0:
        schedule = optax.polynomial_schedule(
            init_value=lr, end_value=0.0, power=poly_power,
            transition_steps=total_steps)
    elif lr_schedule == "step" and lr_step_epochs > 0 and steps_per_epoch > 0:
        schedule = optax.exponential_decay(
            init_value=lr,
            transition_steps=lr_step_epochs * steps_per_epoch,
            decay_rate=lr_gamma,
            staircase=True,
        )
    else:
        schedule = lr
    if optimizer == "sgd":
        return optax.sgd(schedule, momentum=momentum)
    if optimizer != "adam":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return optax.adam(schedule, b1=beta1, b2=beta2, eps=1e-8)


def metrics_to_host(metrics: Dict[str, jax.Array]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def gather_step_fns(impl):
    """Build ``(train_step_gather, train_steps_scan_gather,
    train_steps_scan)`` for a single-network trainer from its step body
    ``impl(state, points, labels, cfg, tx)``.

    The gather variants consume DEVICE-RESIDENT data pools: the host
    transfers only ``[B]`` (or ``[K, B]`` for the scan form) int32 index
    vectors per launch and the batch row-selection (the reference
    Dataset's ``__getitem__``) runs on device via ``jnp.take`` — the
    single-network twin of ``adversarial.train_step_gather``.
    ``train_steps_scan`` is the host-data scan form: K stacked
    ``[K, B, ...]`` data batches per launch (so ``--scan`` works with
    ``--host_data`` too). Numerics are identical across all variants
    (pinned by test_runner device-vs-host equality tests)."""
    import functools

    import jax.numpy as jnp

    from adversarial_learning_on_pointclouds.ops import dispatch

    @functools.partial(jax.jit, static_argnames=("cfg", "tx", "paths"))
    def _gather_jit(state, pool_x, pool_y, idx, *, cfg, tx, paths):
        with dispatch.path_context(paths):
            return impl(state, jnp.take(pool_x, idx, axis=0),
                        jnp.take(pool_y, idx, axis=0), cfg, tx)

    @functools.partial(jax.jit, static_argnames=("cfg", "tx", "paths"))
    def _scan_gather_jit(state, pool_x, pool_y, idx, *, cfg, tx, paths):
        with dispatch.path_context(paths):
            def body(s, ib):
                return impl(s, jnp.take(pool_x, ib, axis=0),
                            jnp.take(pool_y, ib, axis=0), cfg, tx)

            return jax.lax.scan(body, state, idx)

    @functools.partial(jax.jit, static_argnames=("cfg", "tx", "paths"))
    def _scan_jit(state, xs, ys, *, cfg, tx, paths):
        with dispatch.path_context(paths):
            def body(s, xy):
                return impl(s, xy[0], xy[1], cfg, tx)

            return jax.lax.scan(body, state, (xs, ys))

    def train_step_gather(state, pool_x, pool_y, idx, *, cfg, tx):
        return _gather_jit(state, pool_x, pool_y, idx, cfg=cfg, tx=tx,
                           paths=dispatch.current_paths())

    def train_steps_scan_gather(state, pool_x, pool_y, idx, *, cfg, tx):
        return _scan_gather_jit(state, pool_x, pool_y, idx, cfg=cfg,
                                tx=tx, paths=dispatch.current_paths())

    def train_steps_scan(state, xs, ys, *, cfg, tx):
        return _scan_jit(state, xs, ys, cfg=cfg, tx=tx,
                         paths=dispatch.current_paths())

    return train_step_gather, train_steps_scan_gather, train_steps_scan


def epoch_program_fns(impl, eval_inner):
    """Build ``epoch_program(state, pool_x, pool_y, idx, te_args, te_idx,
    cfg=, tx=)`` for a single-network trainer — the FULL epoch (``spe``
    train steps scanned over ``idx [spe, B]`` + the whole-test-pass eval
    scan from ``eval_inner``) as ONE compiled program (``--fused_epoch``;
    the single-net twin of ``adversarial.epoch_program``). Returns
    ``(new_state, metrics [spe], eval_outs)``; one dispatch and one
    readback group per epoch. ``te_args`` is the tuple of device-resident
    eval pools ``eval_inner`` consumes ahead of ``te_idx``."""
    import functools

    import jax.numpy as jnp

    from adversarial_learning_on_pointclouds.ops import dispatch

    @functools.partial(jax.jit, static_argnames=("cfg", "tx", "paths"))
    def _epoch_jit(state, pool_x, pool_y, idx, te_args, te_idx, *,
                   cfg, tx, paths):
        with dispatch.path_context(paths):
            def body(s, ib):
                return impl(s, jnp.take(pool_x, ib, axis=0),
                            jnp.take(pool_y, ib, axis=0), cfg, tx)

            state, ms = jax.lax.scan(body, state, idx)
            ev = eval_inner(state.params, state.bn_state, *te_args,
                            te_idx)
            return state, ms, ev

    def epoch_program(state, pool_x, pool_y, idx, te_args, te_idx, *,
                      cfg, tx):
        return _epoch_jit(state, pool_x, pool_y, idx, tuple(te_args),
                          te_idx, cfg=cfg, tx=tx,
                          paths=dispatch.current_paths())

    return epoch_program
