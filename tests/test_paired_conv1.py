"""``--paired_conv1``: per-point conv1 layers batched across the two
adversarial streams with grouped per-stream BN1 statistics (a
throughput option; its GPU A/B is open in ROADMAP.md).

Same test ladder as ``--paired_heads`` (test_round3.py): the paired path
must be numerics-EXACT vs the sequential path for arbitrary distinct
streams — per-stream statistics, EMA chained a -> b — so loss matches at
fp-rounding level, running stats agree, gradients agree at the
fp-reassociation floor, and the full jitted step trains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

B, N = 8, 64


def _adv_batch(seed=0):
    rng = np.random.default_rng(seed)
    x_l = jnp.asarray(rng.standard_normal((B, N, 3)).astype(np.float32))
    y_l = jnp.asarray(rng.integers(0, 50, (B, N)).astype(np.int32))
    x_u = jnp.asarray(rng.standard_normal((B, N, 3)).astype(np.float32))
    return x_l, y_l, x_u


def test_batch_norm_grouped_3d_matches_sequential():
    """The 3D (per-point) grouped BN reduces over (batch, points) per
    group — exactly two sequential batch_norm calls with chained EMA."""
    from adversarial_learning_on_pointclouds.models import core

    rng = np.random.default_rng(3)
    x_a = jnp.asarray(rng.standard_normal((4, 16, 8)).astype(np.float32))
    x_b = jnp.asarray(rng.standard_normal((4, 16, 8)).astype(np.float32))
    p = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 8).astype(np.float32)),
         "bias": jnp.asarray(rng.standard_normal(8).astype(np.float32))}
    s = {"mean": jnp.zeros(8), "var": jnp.ones(8)}
    y_a, s_a = core.batch_norm(p, s, x_a, True)
    y_b, s_ab = core.batch_norm(p, s_a, x_b, True)
    y_g, s_g = core.batch_norm_grouped(
        p, s, jnp.concatenate([x_a, x_b], axis=0), True, groups=2)
    np.testing.assert_allclose(np.asarray(y_g[:4]), np.asarray(y_a),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(y_g[4:]), np.asarray(y_b),
                               rtol=0, atol=1e-5)
    for stat in ("mean", "var"):
        np.testing.assert_allclose(np.asarray(s_g[stat]),
                                   np.asarray(s_ab[stat]),
                                   rtol=1e-5, atol=1e-7)


def test_paired_conv1_distinct_streams_match_sequential():
    """Loss + conv1 running-stat parity paired_conv1 vs the paired-heads
    default, arbitrary distinct streams."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.train import adversarial

    x_l, y_l, x_u = _adv_batch()
    base = dict(num_parts=50, batch_size=B, num_points=N,
                feature_transform=True, paired_heads=True)
    cfg_seq = AdversarialConfig(paired_conv1=False, **base)
    cfg_pair = AdversarialConfig(paired_conv1=True, **base)
    state = adversarial.create_state(cfg_seq, 1)
    semi_on = jnp.float32(1.0)
    l_seq, aux_seq = adversarial._g_loss_fn(
        state.g_params, state.d_params, state.g_bn_state, x_l, y_l, x_u,
        cfg_seq, semi_on)
    l_pair, aux_pair = adversarial._g_loss_fn(
        state.g_params, state.d_params, state.g_bn_state, x_l, y_l, x_u,
        cfg_pair, semi_on)
    assert float(l_pair) == pytest.approx(float(l_seq), rel=1e-5)
    # Every BN1 the flag touches: encoder conv1 + both T-Net conv1s.
    for path in (("bn1",), ("stn", "bn1"), ("fstn", "bn1")):
        a = aux_seq["bn"]["feat"]
        b = aux_pair["bn"]["feat"]
        for k in path:
            a, b = a[k], b[k]
        for stat in ("mean", "var"):
            av, bv = np.asarray(a[stat]), np.asarray(b[stat])
            scale = np.abs(av).max() + 1e-8
            assert np.abs(av - bv).max() / scale < 1e-5, (path, stat)


def test_paired_conv1_grads_match_sequential_no_pallas():
    """G-gradient parity on the jnp dispatch path (exercises the 3D
    grouped BN inside the full model backward); semi_on=0 kills the
    fp-sensitive threshold masks (same trick as the paired-heads test)."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.ops import dispatch
    from adversarial_learning_on_pointclouds.train import adversarial

    x_l, y_l, x_u = _adv_batch(seed=9)
    base = dict(num_parts=50, batch_size=B, num_points=N,
                feature_transform=True, paired_heads=True,
                use_pallas=False)
    cfg_seq = AdversarialConfig(paired_conv1=False, **base)
    cfg_pair = AdversarialConfig(paired_conv1=True, **base)
    state = adversarial.create_state(cfg_seq, 1)
    semi_on = jnp.float32(0.0)
    with dispatch.use_pallas(False):
        g_seq = jax.grad(lambda p: adversarial._g_loss_fn(
            p, state.d_params, state.g_bn_state, x_l, y_l, x_u, cfg_seq,
            semi_on)[0])(state.g_params)
        g_pair = jax.grad(lambda p: adversarial._g_loss_fn(
            p, state.d_params, state.g_bn_state, x_l, y_l, x_u, cfg_pair,
            semi_on)[0])(state.g_params)
    for a, b in zip(jax.tree_util.tree_leaves(g_seq),
                    jax.tree_util.tree_leaves(g_pair)):
        scale = float(jnp.max(jnp.abs(a)))
        assert float(jnp.max(jnp.abs(a - b))) < 2e-3 * scale + 1e-6


def test_paired_conv1_step_trains():
    """Full jitted G+D step under --paired_conv1: finite metrics, loss
    matches the paired-heads step at fp-rounding level."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.train import adversarial

    x_l, y_l, x_u = _adv_batch(seed=5)
    base = dict(num_parts=50, batch_size=B, num_points=N,
                feature_transform=True, paired_heads=True)
    outs = {}
    for flag in (False, True):
        cfg = AdversarialConfig(paired_conv1=flag, **base)
        g_tx, d_tx = adversarial.make_txs(cfg, steps_per_epoch=4)
        state = adversarial.create_state(cfg, 4)
        state, m = adversarial.train_step(state, x_l, y_l, x_u, cfg=cfg,
                                          g_tx=g_tx, d_tx=d_tx)
        assert all(bool(jnp.isfinite(v)) for v in m.values())
        outs[flag] = float(m["loss_g"])
    assert outs[True] == pytest.approx(outs[False], rel=1e-5)


def test_paired_conv1_cli_requires_paired_heads():
    from adversarial_learning_on_pointclouds.configs import (
        adversarial_config_from_args,
    )
    base = ["--dataset", "x", "--paired_conv1"]
    assert adversarial_config_from_args(base).paired_conv1 is True
    with pytest.raises(SystemExit):
        adversarial_config_from_args(base + ["--no_paired_heads"])
