"""Model-level parity: the kernel route vs. the plain jnp route.

On the CPU the trunk-exit kernel runs in interpreter mode, which a test
asks for explicitly (``use_pallas(interpret=True)``); the same model code
takes the compiled kernel on a GPU. The kernel's own parity tests are in
``tests/test_trunk_pool.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from adversarial_learning_on_pointclouds.models import (
    apply_classifier, apply_segmenter, init_classifier, init_segmenter,
)
from adversarial_learning_on_pointclouds.ops import use_pallas

B, N = 2, 128


def _rand(key, shape):
    return jax.random.normal(jax.random.PRNGKey(key), shape, jnp.float32)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)


def _kernel_route():
    return use_pallas(interpret=True)


def test_classifier_eval_pallas_parity(rng_key):
    params, state = init_classifier(rng_key, 40, feature_transform=True)
    x = _rand(1, (B, N, 3))
    ref, _, _, _ = apply_classifier(params, state, x, train=False)
    with _kernel_route():
        y, _, _, _ = apply_classifier(params, state, x, train=False)
    _close(y, ref, rtol=1e-4)  # log-prob scale


def test_segmenter_eval_pallas_parity(rng_key):
    params, state = init_segmenter(rng_key, 50, feature_transform=True)
    x = _rand(1, (B, N, 3))
    ref, _, _, _ = apply_segmenter(params, state, x, train=False)
    with _kernel_route():
        y, _, _, _ = apply_segmenter(params, state, x, train=False)
    _close(y, ref, rtol=1e-4)


def test_eval_kernels_untileable_n_parity(rng_key):
    """The reference's segmentation N=2500 (no power-of-two tiling) takes
    the kernel route with a masked point tail."""
    params, state = init_segmenter(rng_key, 50, feature_transform=False)
    x = _rand(1, (1, 2500, 3))
    ref, _, _, _ = apply_segmenter(params, state, x, train=False)
    with _kernel_route():
        y, _, _, _ = apply_segmenter(params, state, x, train=False)
    _close(y, ref, rtol=1e-4)


def _grads(params, state, x, labels, route):
    from adversarial_learning_on_pointclouds import losses

    def loss(p):
        logp, _, _, _ = apply_segmenter(p, state, x, train=True)
        return losses.nll_loss(logp, labels)

    if route:
        with _kernel_route():
            return jax.grad(loss)(params)
    return jax.grad(loss)(params)


def test_train_step_with_pallas_matmuls(rng_key):
    """Training forward+backward through the trunk-exit kernel and its
    custom VJP, against jax.grad of the plain route. Batch 16: the T-Net
    fc heads put BatchNorm over the BATCH axis, which amplifies the two
    routes' fp32 reassociation differences at small batch."""
    params, state = init_segmenter(rng_key, 50, feature_transform=False)
    x = _rand(1, (16, 64, 3))
    labels = jax.random.randint(jax.random.PRNGKey(2), (16, 64), 0, 50)
    g_ref = _grads(params, state, x, labels, False)
    g_pal = _grads(params, state, x, labels, True)
    scale = max(float(jnp.max(jnp.abs(l)))
                for l in jax.tree_util.tree_leaves(g_ref))
    for a, r in zip(jax.tree_util.tree_leaves(g_pal),
                    jax.tree_util.tree_leaves(g_ref)):
        assert float(jnp.max(jnp.abs(a - r))) <= 1e-2 * (1 + scale)


def test_mixed_precision_scope():
    """bf16 scope: results deviate from fp32 at ~bf16 epsilon, not more."""
    from adversarial_learning_on_pointclouds.models import core

    x = _rand(0, (B, 64, 3))
    params, state = init_classifier(jax.random.PRNGKey(0), 10)
    ref, _, _, _ = apply_classifier(params, state, x, train=False)
    with core.mixed_precision():
        mp, _, _, _ = apply_classifier(params, state, x, train=False)
    err = float(jnp.max(jnp.abs(mp - ref)))
    assert 0 < err < 0.5, err  # differs (bf16 really used) but sane
    # Scope restores cleanly.
    again, _, _, _ = apply_classifier(params, state, x, train=False)
    np.testing.assert_array_equal(np.asarray(again), np.asarray(ref))


def test_trunk_train_kernel_parity(rng_key):
    """The encoder trunk exit (conv3 + BN3 + max-pool, batch statistics)
    through ``ops.linear_bn_maxpool``: pooled values, the BN running-stat
    update and every gradient match the plain composition."""
    from adversarial_learning_on_pointclouds.models import core
    from adversarial_learning_on_pointclouds.ops import dispatch

    dense = core.torch_linear_init(jax.random.PRNGKey(3), 128, 1024)
    bn_p, bn_s = core.bn_init(1024)
    bn_p = {"scale": 1.0 + 0.1 * _rand(4, (1024,)),
            "bias": 0.1 * _rand(5, (1024,))}
    h = jnp.maximum(_rand(6, (4, 96, 128)), 0.0)
    ct = _rand(7, (4, 1024))

    def run(dense, bn_p, h, route):
        def f(dense, bn_p, h):
            g, s = dispatch.linear_bn_maxpool(dense, bn_p, bn_s, h, True)
            return jnp.sum(g * ct), (g, s)
        if route:
            with _kernel_route():
                return jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(dense, bn_p, h)
        return jax.value_and_grad(f, argnums=(0, 1, 2),
                                  has_aux=True)(dense, bn_p, h)

    (_, (g_r, s_r)), d_r = run(dense, bn_p, h, False)
    (_, (g_k, s_k)), d_k = run(dense, bn_p, h, True)
    _close(g_k, g_r, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s_k),
                    jax.tree_util.tree_leaves(s_r)):
        _close(a, b, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(d_k),
                    jax.tree_util.tree_leaves(d_r)):
        _close(a, b, rtol=1e-4)


def test_train_forward_with_fused_trunk_matches_layerwise(rng_key):
    """Model-level: the train-mode segmenter under the kernel route ==
    the plain route (forward values and BN running-stat updates).

    The exact kernel parity is pinned by test_trunk_train_kernel_parity;
    this test guards the model wiring (stat updates, ReLU-after-pool
    identity, state routing). Batch 16 keeps the fc-head BN's small-batch
    amplification of fp32 reassociation noise below the tolerance."""
    params, state = init_segmenter(rng_key, 50, feature_transform=True)
    x = _rand(1, (16, 64, 3))

    logp_ref, _, _, ns_ref = apply_segmenter(params, state, x, train=True)
    with _kernel_route():
        logp_pal, _, _, ns_pal = apply_segmenter(params, state, x,
                                                 train=True)
    _close(logp_pal, logp_ref, rtol=5e-3)
    for a, b in zip(jax.tree_util.tree_leaves(ns_pal),
                    jax.tree_util.tree_leaves(ns_ref)):
        _close(a, b, rtol=5e-3)


def test_fused_training_kernels_odd_point_count(rng_key):
    """Point counts that aren't a multiple of the kernel's point tile
    still train (masked tail)."""
    from adversarial_learning_on_pointclouds import losses

    params, state = init_segmenter(rng_key, 50, feature_transform=True)
    x = _rand(1, (4, 200, 3))
    labels = jax.random.randint(jax.random.PRNGKey(2), (4, 200), 0, 50)

    with _kernel_route():
        logp, _, _, ns = apply_segmenter(params, state, x, train=True)
        assert logp.shape == (4, 200, 50)
        g = jax.grad(lambda p: losses.nll_loss(
            apply_segmenter(p, state, x, train=True)[0], labels))(params)
    assert all(bool(jnp.all(jnp.isfinite(l)))
               for l in jax.tree_util.tree_leaves(g))
