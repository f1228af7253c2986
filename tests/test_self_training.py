"""--self_training: the D-free confidence-masked pseudo-label control.

Hung et al. arXiv:1802.07934 §5.2's central ablation claim is that the
discriminator's confidence map selects better pseudo-label regions than
the generator's own confidence. ``--self_training`` is the framework's
control for that claim: the exact ``semi_loss`` recipe with the mask
source swapped to ``max softmax(G(x)) > threshold`` and every D
forward/update removed. These tests pin: the loss math on hand-built
inputs, the step semantics (D untouched, adv term zero, total
composition), the empty-mask degeneration to the supervised objective,
and that the stream forwards stay identical to the adversarial path
(the comparison isolates the mask source).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adversarial_learning_on_pointclouds import losses
from adversarial_learning_on_pointclouds.configs import AdversarialConfig
from adversarial_learning_on_pointclouds.train import adversarial

B, N, P = 8, 64, 6


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x_l = jnp.asarray(rng.standard_normal((B, N, 3)), jnp.float32)
    y_l = jnp.asarray(rng.integers(0, P, (B, N)), jnp.int32)
    x_u = jnp.asarray(rng.standard_normal((B, N, 3)), jnp.float32)
    return x_l, y_l, x_u


def test_self_train_loss_hand_computed():
    # Two points: one confident (p=0.7 -> masked in at T=0.5), one not
    # (p=0.4 -> masked out). Loss = -log(0.7) over the 1-point mask.
    probs = jnp.asarray([[[0.7, 0.2, 0.1], [0.4, 0.35, 0.25]]],
                        jnp.float32)
    logp = jnp.log(probs)
    got = float(losses.self_train_loss(logp, 0.5))
    assert got == pytest.approx(-np.log(0.7), rel=1e-6)
    # Empty mask -> exactly 0 (denominator clamp, no NaN).
    assert float(losses.self_train_loss(logp, 0.99)) == 0.0


def test_self_train_loss_gradient_ignores_masked_out_points():
    probs = jnp.asarray([[[0.7, 0.2, 0.1], [0.4, 0.35, 0.25]]],
                        jnp.float32)
    logp = jnp.log(probs)
    g = jax.grad(lambda lp: losses.self_train_loss(lp, 0.5))(logp)
    # Only the confident point's row carries gradient.
    assert float(jnp.max(jnp.abs(g[0, 1]))) == 0.0
    assert float(jnp.max(jnp.abs(g[0, 0]))) > 0.0


@pytest.mark.parametrize("paired", [True, False])
def test_self_training_step_freezes_d_and_drops_adv(paired):
    cfg = AdversarialConfig(num_parts=P, batch_size=B, num_points=N,
                            self_training=True, feature_transform=True,
                            paired_heads=paired, semi_threshold=0.05)
    g_tx, d_tx = adversarial.make_txs(cfg, 1)
    state = adversarial.create_state(cfg, 1)
    x_l, y_l, x_u = _batch()
    new_state, m = adversarial.train_step(state, x_l, y_l, x_u, cfg=cfg,
                                          g_tx=g_tx, d_tx=d_tx)
    assert float(m["loss_adv"]) == 0.0
    assert float(m["loss_d"]) == 0.0
    # Total composes CE + lambda_semi * masked self-training term.
    assert float(m["loss_g"]) == pytest.approx(
        float(m["loss_ce"]) + cfg.lambda_semi * float(m["loss_semi"]),
        rel=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(state.d_params),
                    jax.tree_util.tree_leaves(new_state.d_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    changed = any(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(state.g_params),
                        jax.tree_util.tree_leaves(new_state.g_params)))
    assert changed


def test_self_training_empty_mask_reduces_to_supervised_objective():
    # threshold >= 1.0: max softmax can never exceed it -> the semi term
    # vanishes and the G objective equals the adversarial path's CE term
    # (same two stream forwards, same ortho reg over both transforms).
    cfg = AdversarialConfig(num_parts=P, batch_size=B, num_points=N,
                            self_training=True, feature_transform=True,
                            semi_threshold=1.0)
    state = adversarial.create_state(cfg, 1)
    x_l, y_l, x_u = _batch(1)
    total, aux = adversarial._g_loss_fn(
        state.g_params, state.d_params, state.g_bn_state, x_l, y_l, x_u,
        cfg, jnp.float32(1.0))
    assert float(aux["l_semi"]) == 0.0
    assert float(total) == float(aux["l_ce"])
    # ... and that CE term matches the adversarial path's bitwise (the
    # stream forwards are shared code, so st-vs-adv isolates the mask
    # source + adv term).
    cfg_adv = AdversarialConfig(num_parts=P, batch_size=B, num_points=N,
                                feature_transform=True)
    _, aux_adv = adversarial._g_loss_fn(
        state.g_params, state.d_params, state.g_bn_state, x_l, y_l, x_u,
        cfg_adv, jnp.float32(1.0))
    assert float(aux["l_ce"]) == float(aux_adv["l_ce"])


def test_self_training_excludes_supervised_only():
    cfg = AdversarialConfig(num_parts=P, batch_size=B, num_points=N,
                            self_training=True, supervised_only=True)
    with pytest.raises(AssertionError):
        adversarial.create_state(cfg, 1)


def test_cli_flag_roundtrip():
    from adversarial_learning_on_pointclouds import configs

    cfg = configs.adversarial_config_from_args(
        ["--dataset", "x", "--self_training"])
    assert cfg.self_training and not cfg.supervised_only
    cfg = configs.adversarial_config_from_args(["--dataset", "x"])
    assert not cfg.self_training
