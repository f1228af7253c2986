"""--d_geometry: the geometry-aware discriminator EXTENSION.

The reference's pointwise D judges per-point class probabilities only
(docs/ADVERSARIAL_GAIN.md: its prior reduces to marginal
shape). The extension appends the augmented xyz coordinates to the D
input so it can judge label-geometry consistency. These tests pin: the
widened D architecture, coordinates actually reaching the D (same probs
+ different xyz => different D loss), a full G+D step training under
the flag on every forward variant, and the default staying bitwise the
reference architecture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adversarial_learning_on_pointclouds.configs import AdversarialConfig
from adversarial_learning_on_pointclouds.train import adversarial

B, N, P = 8, 64, 6


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x_l = jnp.asarray(rng.standard_normal((B, N, 3)), jnp.float32)
    y_l = jnp.asarray(rng.integers(0, P, (B, N)), jnp.int32)
    x_u = jnp.asarray(rng.standard_normal((B, N, 3)), jnp.float32)
    return x_l, y_l, x_u


def test_d_geometry_widens_d_input():
    cfg = AdversarialConfig(num_parts=P, batch_size=B, num_points=N,
                            d_geometry=True)
    st = adversarial.create_state(cfg, 1)
    assert st.d_params["conv1"]["w"].shape[0] == P + 3
    cfg0 = AdversarialConfig(num_parts=P, batch_size=B, num_points=N)
    st0 = adversarial.create_state(cfg0, 1)
    assert st0.d_params["conv1"]["w"].shape[0] == P


def test_d_geometry_coordinates_reach_the_d():
    cfg = AdversarialConfig(num_parts=P, batch_size=B, num_points=N,
                            d_geometry=True)
    st = adversarial.create_state(cfg, 1)
    rng = np.random.default_rng(1)
    probs = jax.nn.softmax(
        jnp.asarray(rng.standard_normal((B, N, P)), jnp.float32))
    y = jnp.asarray(rng.integers(0, P, (B, N)), jnp.int32)
    xyz_a = jnp.asarray(rng.standard_normal((B, N, 3)), jnp.float32)
    xyz_b = xyz_a + 1.0
    la = float(adversarial._d_loss_fn(st.d_params, probs, probs, y, P,
                                      (xyz_a, xyz_a))[0])
    lb = float(adversarial._d_loss_fn(st.d_params, probs, probs, y, P,
                                      (xyz_b, xyz_b))[0])
    assert la != pytest.approx(lb, abs=1e-6)


@pytest.mark.parametrize("variant", ["paired", "sequential", "fused"])
def test_d_geometry_step_trains_every_variant(variant):
    cfg = AdversarialConfig(
        num_parts=P, batch_size=B, num_points=N, feature_transform=True,
        d_geometry=True,
        paired_heads=(variant == "paired"),
        fused_forward=(variant == "fused"))
    g_tx, d_tx = adversarial.make_txs(cfg, 2)
    st = adversarial.create_state(cfg, 2)
    x_l, y_l, x_u = _batch()
    for _ in range(2):
        st, m = adversarial.train_step(st, x_l, y_l, x_u, cfg=cfg,
                                       g_tx=g_tx, d_tx=d_tx)
    for k, v in m.items():
        assert np.isfinite(float(v)), (variant, k, v)
    # The adversarial term must actually flow: the widened D moved.
    assert float(m["loss_d"]) > 0.0


def test_d_in_off_is_identity():
    x = jnp.ones((2, 4, 5))
    assert adversarial._d_in(x, jnp.zeros((2, 4, 3)), False) is x


def test_d_geometry_step_trains_under_pallas_dispatch():
    """The widened D input (C = parts+3 = 9 here, 53 at reference size)
    trains on the kernel route too (the trunk-exit kernel in interpreter
    mode on CPU; chip_smoke.py runs the compiled route)."""
    from adversarial_learning_on_pointclouds.ops import use_pallas

    cfg = AdversarialConfig(num_parts=P, batch_size=B, num_points=N,
                            feature_transform=True, d_geometry=True)
    g_tx, d_tx = adversarial.make_txs(cfg, 2)
    st = adversarial.create_state(cfg, 2)
    x_l, y_l, x_u = _batch(2)
    with use_pallas(True, interpret=True):
        st, m = adversarial.train_step(st, x_l, y_l, x_u, cfg=cfg,
                                       g_tx=g_tx, d_tx=d_tx)
        st, m = adversarial.train_step(st, x_l, y_l, x_u, cfg=cfg,
                                       g_tx=g_tx, d_tx=d_tx)
    for k, v in m.items():
        assert np.isfinite(float(v)), (k, v)


def test_d_geometry_pallas_matches_xla_loss():
    """Same step, kernel route vs plain route: the losses must agree at
    the fp-reassociation floor with the widened D input."""
    from adversarial_learning_on_pointclouds.ops import use_pallas

    cfg = AdversarialConfig(num_parts=P, batch_size=B, num_points=N,
                            feature_transform=False, augment=False,
                            resample=False, normalize=False,
                            d_geometry=True)
    g_tx, d_tx = adversarial.make_txs(cfg, 1)
    st = adversarial.create_state(cfg, 1)
    x_l, y_l, x_u = _batch(3)
    with use_pallas(False):
        _, m0 = adversarial.train_step(st, x_l, y_l, x_u, cfg=cfg,
                                       g_tx=g_tx, d_tx=d_tx)
    with use_pallas(True, interpret=True):
        _, m1 = adversarial.train_step(st, x_l, y_l, x_u, cfg=cfg,
                                       g_tx=g_tx, d_tx=d_tx)
    for k in ("loss_g", "loss_d", "loss_ce"):
        a, b = float(m0[k]), float(m1[k])
        assert abs(a - b) <= 2e-4 * (1 + abs(a)), (k, a, b)
