"""Loss tests with hand-computed cases (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adversarial_learning_on_pointclouds import losses


def test_nll_loss_hand_computed():
    logp = jnp.log(jnp.array([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1]]))
    labels = jnp.array([0, 1])
    expected = -(np.log(0.7) + np.log(0.8)) / 2
    assert float(losses.nll_loss(logp, labels)) == pytest.approx(expected, rel=1e-4)


def test_nll_loss_per_point():
    logp = jnp.log(jnp.full((2, 4, 5), 0.2))
    labels = jnp.zeros((2, 4), dtype=jnp.int32)
    assert float(losses.nll_loss(logp, labels)) == pytest.approx(
        -np.log(0.2), rel=1e-4)


def test_bce_with_logits_matches_formula():
    z = jnp.array([0.0, 2.0, -3.0])
    # BCE(z, 1) = log(1 + exp(-z))
    expected = np.mean(np.log1p(np.exp(-np.asarray(z))))
    assert float(losses.bce_with_logits(z, 1.0)) == pytest.approx(expected, rel=1e-4)
    # BCE(z, 0) = log(1 + exp(z))
    expected0 = np.mean(np.log1p(np.exp(np.asarray(z))))
    assert float(losses.bce_with_logits(z, 0.0)) == pytest.approx(expected0, rel=1e-4)


def test_bce_stable_at_extreme_logits():
    z = jnp.array([1000.0, -1000.0])
    v = float(losses.bce_with_logits(z, 1.0))
    assert np.isfinite(v)
    assert v == pytest.approx(500.0, rel=1e-3)  # only the -1000 term costs


def test_d_loss_and_g_loss():
    real = jnp.zeros((2, 3, 1))
    fake = jnp.zeros((2, 3, 1))
    # At logit 0: each BCE term = log 2.
    assert float(losses.d_loss(real, fake)) == pytest.approx(
        2 * np.log(2), rel=1e-4)
    assert float(losses.adv_g_loss(fake)) == pytest.approx(np.log(2), rel=1e-4)


def test_semi_loss_masking():
    # 2 points: D confident (sigmoid(5) > 0.2) on point 0 only.
    logp = jnp.log(jnp.array([[[0.9, 0.1], [0.5, 0.5]]]))
    d_logits = jnp.array([[[5.0], [-5.0]]])
    v = float(losses.semi_loss(logp, d_logits, threshold=0.2))
    # Only point 0 contributes: pseudo-label=0, loss=-log 0.9.
    assert v == pytest.approx(-np.log(0.9), rel=1e-4)


def test_semi_loss_empty_mask_is_zero_and_grad_safe():
    logp = jnp.log(jnp.full((1, 4, 2), 0.5))
    d_logits = jnp.full((1, 4, 1), -50.0)
    v = float(losses.semi_loss(logp, d_logits, threshold=0.9))
    assert v == 0.0
    g = jax.grad(lambda lp: losses.semi_loss(lp, d_logits, 0.9))(logp)
    assert np.all(np.isfinite(np.asarray(g)))


def test_ortho_reg_hand_computed():
    # A = 2I (k=2): I - A A^T = I - 4I = -3I, Frobenius norm = 3*sqrt(2).
    t = jnp.stack([2.0 * jnp.eye(2)])
    assert float(losses.orthogonality_reg(t)) == pytest.approx(
        3 * np.sqrt(2), rel=1e-4)
    assert float(losses.orthogonality_reg(None)) == 0.0


def test_semi_loss_no_grad_through_mask_or_pseudo():
    """Gradient flows only through the picked log-prob, not mask/argmax."""
    logp = jax.nn.log_softmax(
        jax.random.normal(jax.random.PRNGKey(0), (2, 8, 5)), -1)
    d_logits = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 1))
    g = jax.grad(lambda lp: losses.semi_loss(lp, d_logits, 0.2))(logp)
    assert np.all(np.isfinite(np.asarray(g)))
