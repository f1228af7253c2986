"""Integration tests: each config's jitted step runs, learns, and respects
freeze semantics (SURVEY.md §4 "Integration")."""

import jax
import jax.numpy as jnp
import numpy as np

from adversarial_learning_on_pointclouds.configs import (
    AdversarialConfig, AdvPerturbConfig, ClassifyConfig, SegmentConfig,
)
from adversarial_learning_on_pointclouds.train import (
    adv_perturb, adversarial, classify, segment,
)

B, N = 8, 64


def _cls_batch(num_classes=4):
    rng = np.random.default_rng(0)
    labels = np.arange(B) % num_classes
    pts = rng.standard_normal((B, N, 3)).astype(np.float32)
    pts[:, :, 0] += labels[:, None] * 2.0  # separable
    return jnp.asarray(pts), jnp.asarray(labels.astype(np.int32))


def _seg_batch():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((B, N, 3)).astype(np.float32)
    seg = (pts[:, :, 0] > 0).astype(np.int32)  # parts 0/1 split on x
    return jnp.asarray(pts), jnp.asarray(seg)


def test_classify_overfit():
    cfg = ClassifyConfig(num_classes=4, epochs=1, batch_size=B,
                         num_points=N, feature_transform=True)
    tx = classify.make_tx(cfg, steps_per_epoch=1)
    state = classify.create_state(cfg, steps_per_epoch=1)
    pts, labels = _cls_batch()
    first_loss = None
    for _ in range(40):
        state, m = classify.train_step(state, pts, labels, cfg=cfg, tx=tx)
        if first_loss is None:
            first_loss = float(m["loss"])
    assert float(m["loss"]) < first_loss * 0.5
    assert float(m["acc"]) > 0.8
    assert int(state.step) == 40


def test_classify_eval_step():
    cfg = ClassifyConfig(num_classes=4, batch_size=B, num_points=N)
    state = classify.create_state(cfg, steps_per_epoch=1)
    pts, labels = _cls_batch()
    out = classify.eval_step(state.params, state.bn_state, pts, labels)
    assert out["log_probs"].shape == (B, 4)
    assert 0 <= int(out["correct"]) <= B


def test_segment_overfit():
    cfg = SegmentConfig(num_parts=2, batch_size=B, num_points=N,
                        feature_transform=False)
    tx = segment.make_tx(cfg, steps_per_epoch=1)
    state = segment.create_state(cfg, steps_per_epoch=1)
    pts, seg_labels = _seg_batch()
    for _ in range(30):
        state, m = segment.train_step(state, pts, seg_labels, cfg=cfg, tx=tx)
    assert float(m["acc"]) > 0.9


def test_adversarial_step_updates_and_freezes():
    """Both G and D must change; D must be frozen during the G step."""
    cfg = AdversarialConfig(num_parts=2, batch_size=B, num_points=N,
                            feature_transform=False)
    g_tx, d_tx = adversarial.make_txs(cfg, steps_per_epoch=1)
    state = adversarial.create_state(cfg, steps_per_epoch=1)
    pts, seg_labels = _seg_batch()
    x_u = pts + 0.1

    g0 = jax.tree_util.tree_leaves(state.g_params)[0].copy()
    d0 = jax.tree_util.tree_leaves(state.d_params)[0].copy()
    new_state, m = adversarial.train_step(
        state, pts, seg_labels, x_u, cfg=cfg, g_tx=g_tx, d_tx=d_tx)
    g1 = jax.tree_util.tree_leaves(new_state.g_params)[0]
    d1 = jax.tree_util.tree_leaves(new_state.d_params)[0]
    assert not np.allclose(np.asarray(g0), np.asarray(g1))
    assert not np.allclose(np.asarray(d0), np.asarray(d1))
    for k in ("loss_g", "loss_ce", "loss_adv", "loss_semi", "loss_d"):
        assert np.isfinite(float(m[k])), k
    assert int(new_state.step) == 1

    # Freeze check: with lambda_adv = lambda_semi = 0 the G update must not
    # depend on D's parameters at all.
    cfg0 = AdversarialConfig(num_parts=2, batch_size=B, num_points=N,
                             feature_transform=False,
                             lambda_adv=0.0, lambda_semi=0.0)
    sA = adversarial.create_state(cfg0, 1)
    d_perturbed = jax.tree_util.tree_map(lambda p: p + 1.0, sA.d_params)
    sB = sA._replace(d_params=d_perturbed)
    outA, _ = adversarial.train_step(sA, pts, seg_labels, x_u,
                                     cfg=cfg0, g_tx=g_tx, d_tx=d_tx)
    outB, _ = adversarial.train_step(sB, pts, seg_labels, x_u,
                                     cfg=cfg0, g_tx=g_tx, d_tx=d_tx)
    for a, b in zip(jax.tree_util.tree_leaves(outA.g_params),
                    jax.tree_util.tree_leaves(outB.g_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_adversarial_gan_learns():
    cfg = AdversarialConfig(num_parts=2, batch_size=B, num_points=N,
                            feature_transform=False)
    g_tx, d_tx = adversarial.make_txs(cfg, steps_per_epoch=1)
    state = adversarial.create_state(cfg, steps_per_epoch=1)
    pts, seg_labels = _seg_batch()
    x_u = pts + 0.05
    for _ in range(25):
        state, m = adversarial.train_step(state, pts, seg_labels, x_u,
                                          cfg=cfg, g_tx=g_tx, d_tx=d_tx)
    assert float(m["acc"]) > 0.8
    assert float(m["loss_d"]) < 2 * np.log(2) + 0.5  # D not diverging


def test_semi_start_gates_semi_loss():
    cfg = AdversarialConfig(num_parts=2, batch_size=B, num_points=N,
                            feature_transform=False, semi_start=1000)
    g_tx, d_tx = adversarial.make_txs(cfg, steps_per_epoch=1)
    state = adversarial.create_state(cfg, 1)
    pts, seg_labels = _seg_batch()
    _, m = adversarial.train_step(state, pts, seg_labels, pts + 0.1,
                                  cfg=cfg, g_tx=g_tx, d_tx=d_tx)
    # loss_semi is reported but must not contribute: loss_g == ce + adv.
    expect = float(m["loss_ce"]) + cfg.lambda_adv * float(m["loss_adv"])
    assert float(m["loss_g"]) == np.float32(expect) or \
        abs(float(m["loss_g"]) - expect) < 1e-5


def test_fgsm_perturb_step():
    cfg = AdvPerturbConfig(num_classes=4, batch_size=B, num_points=N,
                           epsilon=0.05)
    tx = adv_perturb.make_tx(cfg, steps_per_epoch=1)
    state = adv_perturb.create_state(cfg, steps_per_epoch=1)
    pts, labels = _cls_batch()
    for _ in range(10):
        state, m = adv_perturb.train_step(state, pts, labels, cfg=cfg, tx=tx)
    assert np.isfinite(float(m["loss"]))
    assert int(state.step) == 10


def test_fgsm_attack_moves_points_by_epsilon():
    from adversarial_learning_on_pointclouds import attacks, losses
    from adversarial_learning_on_pointclouds.models import (
        apply_classifier, init_classifier,
    )
    params, bn = init_classifier(jax.random.PRNGKey(0), 4)
    pts, labels = _cls_batch()

    def loss(x):
        logp, _, _, _ = apply_classifier(params, bn, x, train=False)
        return losses.nll_loss(logp, labels)

    x_adv = attacks.fgsm_points(loss, pts, 0.03)
    delta = np.abs(np.asarray(x_adv - pts))
    # sign() moves every coordinate by exactly eps (up to zero-grad coords).
    assert delta.max() <= 0.03 + 1e-6
    assert np.mean(delta > 0.029) > 0.5
