"""Config 5: FGSM adversarial-perturbation training (``BASELINE.json:11``).

Rebuild of the reference's attack-augmented trainer (SURVEY.md §2.6,
§3.4): per batch, run an FGSM gradient-sign jitter attack on the input
coordinates, then a standard supervised update on the perturbed clouds.
In JAX the attack is a nested ``jax.grad`` w.r.t. the *input* inside the
same jitted step (two forwards + two backwards, like the reference).
Designed to run under multi-chip DP (the other half of config 5) via
``parallel/mesh.py`` shardings — the step function is mesh-agnostic.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds import attacks, losses
from adversarial_learning_on_pointclouds.configs import AdvPerturbConfig
from adversarial_learning_on_pointclouds.data import augment
from adversarial_learning_on_pointclouds.models import apply_classifier
from adversarial_learning_on_pointclouds.train import classify
from adversarial_learning_on_pointclouds.train import state as state_lib


def create_state(cfg: AdvPerturbConfig, steps_per_epoch: int,
                 rng: Optional[jax.Array] = None) -> state_lib.TrainState:
    return classify.create_state(cfg, steps_per_epoch, rng)


def make_tx(cfg: AdvPerturbConfig, steps_per_epoch: int):
    return classify.make_tx(cfg, steps_per_epoch)


def _train_step_impl(state, points, labels, cfg: AdvPerturbConfig, tx):
    from adversarial_learning_on_pointclouds.ops import dispatch

    # NB the 4-way split is part of the pinned RNG stream (determinism
    # tests) — the third key is reserved for a train-mode attack forward's
    # dropout, which the eval-mode attack does not consume.
    rng, k_aug, _k_attack_drop, k_drop2 = jax.random.split(state.rng, 4)
    points = augment.chain_from_cfg(k_aug, cfg, points)

    # FGSM attack: eval-mode forward for the input gradient (the attack
    # must not perturb BN running stats), matching the reference's
    # model.eval() during attack generation. The attack section forces
    # the plain XLA path: the eval-mode trunk-exit kernel carries no VJP
    # (it exists for inference, where nothing differentiates through
    # it). Trace-time flag, so this is baked into the compiled program;
    # the post-attack supervised update keeps the kernel route.
    def attack_loss(x):
        logp, _, _, _ = apply_classifier(
            state.params, state.bn_state, x, train=False)
        return losses.nll_loss(logp, labels)

    with dispatch.use_pallas(False):
        if cfg.attack == "pgd" and cfg.attack_steps > 1:
            # cfg is a static jit arg, so the attack choice is baked into
            # the compiled program; the PGD loop is a lax.fori_loop (one
            # program either way). steps=1 PGD is exactly FGSM (alpha =
            # eps, the projection is then a no-op), so it takes the same
            # single-grad path.
            x_adv = attacks.iterated_fgsm_points(
                attack_loss, points, cfg.epsilon, cfg.attack_steps)
        else:
            x_adv = attacks.fgsm_points(attack_loss, points, cfg.epsilon)

    # Standard supervised update on the perturbed batch.
    (loss, (new_bn, acc)), grads = jax.value_and_grad(
        classify.loss_fn, has_aux=True)(
            state.params, state.bn_state, x_adv, labels, k_drop2, cfg)
    updates, new_opt = tx.update(grads, state.opt_state, state.params)
    new_params = jax.tree_util.tree_map(
        lambda p, u: p + u, state.params, updates)
    new_state = state_lib.TrainState(new_params, new_bn, new_opt,
                                     state.step + 1, rng)
    return new_state, {"loss": loss, "acc": acc}


@functools.partial(jax.jit, static_argnames=("cfg", "tx", "paths"))
def _train_step(state, points, labels, *, cfg: AdvPerturbConfig, tx, paths):
    from adversarial_learning_on_pointclouds.ops import dispatch
    with dispatch.path_context(paths):
        return _train_step_impl(state, points, labels, cfg, tx)


def train_step(state: state_lib.TrainState, points: jnp.ndarray,
               labels: jnp.ndarray, *, cfg: AdvPerturbConfig, tx,
               ) -> Tuple[state_lib.TrainState, Dict[str, jnp.ndarray]]:
    """Preprocess chain -> FGSM attack -> supervised update on the
    perturbed batch. Pallas/bf16 path flags are jit-cache-keyed."""
    from adversarial_learning_on_pointclouds.ops import dispatch
    return _train_step(state, points, labels, cfg=cfg, tx=tx,
                       paths=dispatch.current_paths())


# Device-resident-pool variants (see state_lib.gather_step_fns).
train_step_gather, train_steps_scan_gather, train_steps_scan = \
    state_lib.gather_step_fns(_train_step_impl)


# Fused whole-epoch program (--fused_epoch): the attack trainer shares
# the classifier's eval protocol, so its epoch program ends in the same
# eval scan (state_lib.epoch_program_fns).
epoch_program = state_lib.epoch_program_fns(
    _train_step_impl, classify.eval_scan_inner)
