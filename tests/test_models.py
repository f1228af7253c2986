"""Model unit tests: shapes, T-Net near-identity at init, BN state updates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adversarial_learning_on_pointclouds import losses
from adversarial_learning_on_pointclouds.models import (
    apply_classifier, apply_discriminator, apply_encoder, apply_segmenter,
    apply_tnet, init_classifier, init_discriminator, init_encoder,
    init_segmenter, init_tnet,
)

B, N = 4, 128


def test_tnet_shapes_and_near_identity(rng_key):
    params, state = init_tnet(rng_key, k=3)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, N, 3))
    t, new_state = apply_tnet(params, state, x, train=False)
    assert t.shape == (B, 3, 3)
    # fc3 torch-default init is U(-1/16, 1/16); identity dominates.
    np.testing.assert_allclose(np.asarray(t), np.eye(3)[None].repeat(B, 0),
                               atol=0.1)
    # Eval mode must not touch BN state.
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(jnp.all(a == b)), state, new_state))


def test_tnet_feature_k64(rng_key):
    params, state = init_tnet(rng_key, k=64)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, N, 64))
    t, _ = apply_tnet(params, state, x, train=True)
    assert t.shape == (B, 64, 64)


@pytest.mark.parametrize("ft", [False, True])
def test_encoder_global(rng_key, ft):
    params, state = init_encoder(rng_key, feature_transform=ft)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, N, 3))
    feat, trans, trans_feat, new_state = apply_encoder(
        params, state, x, train=True, global_feat=True)
    assert feat.shape == (B, 1024)
    assert trans.shape == (B, 3, 3)
    assert (trans_feat is None) == (not ft)
    # Train mode must update BN running stats.
    assert not bool(jnp.all(new_state["bn1"]["mean"] == state["bn1"]["mean"]))


def test_encoder_dense(rng_key):
    params, state = init_encoder(rng_key, feature_transform=True)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, N, 3))
    feat, _, trans_feat, _ = apply_encoder(
        params, state, x, train=True, global_feat=False)
    assert feat.shape == (B, N, 1088)
    assert trans_feat.shape == (B, 64, 64)


def test_classifier(rng_key):
    params, state = init_classifier(rng_key, num_classes=40)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, N, 3))
    logp, _, _, _ = apply_classifier(params, state, x, train=True,
                                     rng=jax.random.PRNGKey(2))
    assert logp.shape == (B, 40)
    np.testing.assert_allclose(np.exp(np.asarray(logp)).sum(-1),
                               np.ones(B), rtol=1e-3)


def test_classifier_eval_deterministic(rng_key):
    params, state = init_classifier(rng_key)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, N, 3))
    a, _, _, _ = apply_classifier(params, state, x, train=False)
    b, _, _, _ = apply_classifier(params, state, x, train=False)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_segmenter(rng_key):
    params, state = init_segmenter(rng_key, num_parts=50)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, N, 3))
    logp, trans, trans_feat, _ = apply_segmenter(params, state, x, train=True)
    assert logp.shape == (B, N, 50)
    np.testing.assert_allclose(np.exp(np.asarray(logp)).sum(-1),
                               np.ones((B, N)), rtol=1e-3)


def test_discriminator(rng_key):
    params = init_discriminator(rng_key, num_parts=50)
    probs = jax.nn.softmax(
        jax.random.normal(jax.random.PRNGKey(1), (B, N, 50)), -1)
    out = apply_discriminator(params, probs)
    assert out.shape == (B, N, 1)


def test_ortho_reg_zero_for_orthonormal():
    t = jnp.stack([jnp.eye(64)] * B)
    assert float(losses.orthogonality_reg(t)) == pytest.approx(0.0, abs=1e-5)
    t2 = 2.0 * t
    assert float(losses.orthogonality_reg(t2)) > 1.0


def test_permutation_invariance(rng_key):
    """The symmetric max-pool makes the global feature order-invariant."""
    params, state = init_encoder(rng_key)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, N, 3))
    perm = jax.random.permutation(jax.random.PRNGKey(2), N)
    f1, _, _, _ = apply_encoder(params, state, x, train=False)
    f2, _, _, _ = apply_encoder(params, state, x[:, perm], train=False)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), atol=1e-5)


def test_batch_norm_variance_no_cancellation_after_warmup():
    """One-pass BN moments are taken about the RUNNING mean: once the
    running stats have adapted, the variance of data with |mean| >> std
    (e.g. world-frame clouds under --no_normalize) stays accurate instead
    of losing ~all fp32 bits to E[x^2]-E[x]^2 cancellation."""
    import jax.numpy as jnp

    from adversarial_learning_on_pointclouds.models import core

    rng = np.random.default_rng(0)
    x = (1000.0 + rng.standard_normal((16, 32, 8)) * 0.5).astype(np.float32)
    p = {"scale": jnp.ones(8), "bias": jnp.zeros(8)}
    s = {"mean": jnp.zeros(8), "var": jnp.ones(8)}
    for _ in range(60):  # momentum 0.1 -> running mean ~ true mean
        _, s = core.batch_norm(p, s, jnp.asarray(x), train=True)
    _, s2 = core.batch_norm(p, s, jnp.asarray(x), train=True)
    # Recover the batch variance this step observed from the EMA update.
    var_obs = (np.asarray(s2["var"]) - 0.9 * np.asarray(s["var"])) / 0.1
    var_true = x.reshape(-1, 8).var(axis=0, ddof=1)
    np.testing.assert_allclose(var_obs, var_true, rtol=5e-2)
    assert (var_obs > 0.1).all()  # raw one-pass collapses these to ~0
