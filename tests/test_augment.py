"""Augmentation chain tests: shapes, determinism, bounds, invariants."""

import jax
import jax.numpy as jnp
import numpy as np

from adversarial_learning_on_pointclouds.data import augment

B, N = 4, 64


def _cloud(key=1):
    return jax.random.normal(jax.random.PRNGKey(key), (B, N, 3)) * 3.0 + 1.0


def test_normalize_unit_sphere():
    x = _cloud()
    y = augment.normalize_unit_sphere(x)
    centroid = np.asarray(jnp.mean(y, axis=1))
    np.testing.assert_allclose(centroid, 0.0, atol=1e-5)
    norms = np.asarray(jnp.linalg.norm(y, axis=-1))
    assert norms.max() <= 1.0 + 1e-5
    np.testing.assert_allclose(norms.max(axis=1), 1.0, atol=1e-5)


def test_rotate_preserves_norms_and_y():
    x = _cloud()
    y = augment.random_rotate(jax.random.PRNGKey(0), x)
    # Rotation about Y: per-point norms and Y coordinates unchanged.
    np.testing.assert_allclose(np.asarray(jnp.linalg.norm(x, axis=-1)),
                               np.asarray(jnp.linalg.norm(y, axis=-1)),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(x[..., 1]), np.asarray(y[..., 1]),
                               atol=1e-5)
    assert not np.allclose(np.asarray(x), np.asarray(y))


def test_jitter_clip_bounds():
    x = _cloud()
    y = augment.jitter(jax.random.PRNGKey(0), x, sigma=0.5, clip=0.05)
    delta = np.abs(np.asarray(y - x))
    assert delta.max() <= 0.05 + 1e-6
    assert delta.max() > 0.0


def test_point_dropout_replaces_with_first_point():
    x = _cloud()
    y = augment.point_dropout(jax.random.PRNGKey(3), x, max_dropout_ratio=0.95)
    xn, yn = np.asarray(x), np.asarray(y)
    changed = ~np.all(np.isclose(xn, yn), axis=-1)
    assert changed.any()
    # Every changed point must equal that cloud's first point.
    for b in range(B):
        for i in np.nonzero(changed[b])[0]:
            np.testing.assert_allclose(yn[b, i], xn[b, 0], atol=1e-6)
    # First point is never changed (it's its own replacement).
    np.testing.assert_allclose(yn[:, 0], xn[:, 0], atol=1e-6)


def test_resample_fixed_n_with_labels():
    x = _cloud()
    labels = jax.random.randint(jax.random.PRNGKey(1), (B, N), 0, 50)
    pts, lab = augment.resample_fixed_n(jax.random.PRNGKey(2), x, 32, labels)
    assert pts.shape == (B, 32, 3)
    assert lab.shape == (B, 32)
    # Every resampled point must come from the source cloud, with its label.
    xn = np.asarray(x)
    for b in range(B):
        for i in range(32):
            dists = np.linalg.norm(xn[b] - np.asarray(pts[b, i]), axis=-1)
            src = int(np.argmin(dists))
            assert dists[src] < 1e-6
            assert int(lab[b, i]) == int(labels[b, src])


def test_augment_batch_deterministic_under_fixed_key():
    x = _cloud()
    key = jax.random.PRNGKey(7)
    a = augment.augment_batch(key, x, dropout=True, normalize=True)
    b = augment.augment_batch(key, x, dropout=True, normalize=True)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c = augment.augment_batch(jax.random.PRNGKey(8), x)
    assert not np.allclose(np.asarray(a), np.asarray(c))


def test_augment_batch_jits():
    x = _cloud()
    f = jax.jit(lambda k, p: augment.augment_batch(k, p, dropout=True))
    y = f(jax.random.PRNGKey(0), x)
    assert y.shape == x.shape
