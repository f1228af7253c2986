"""Round-3 feature tests: AsyncSaver keep-up policy, PGD training surface,
paired heads, fused epochs, grouped BN and the new CLI flags."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adversarial_learning_on_pointclouds.configs import (
    AdvPerturbConfig, adv_perturb_config_from_args,
    classify_config_from_args,
)
from adversarial_learning_on_pointclouds.train import adv_perturb
from adversarial_learning_on_pointclouds.utils import checkpoint

B, N = 8, 64


# ---------------------------------------------------------------------------
# AsyncSaver keep-up policy (VERDICT r2 weak #5 / next #7)
# ---------------------------------------------------------------------------

def _slow_recording_save(written, delay=0.05):
    def fake_save(ckpt_dir, step, state):
        time.sleep(delay)
        written.append(step)
    return fake_save


def test_async_saver_skip_to_latest_final_durable(tmp_path, monkeypatch):
    """'latest' policy: saves never block behind a slow writer, stale
    snapshots are skipped, and the FINAL state is always written."""
    written = []
    monkeypatch.setattr(checkpoint, "save", _slow_recording_save(written))
    t0 = time.perf_counter()
    with checkpoint.AsyncSaver(policy="latest") as saver:
        for step in range(20):
            saver.save(str(tmp_path), step, {"w": step})
    elapsed = time.perf_counter() - t0
    assert written, "nothing written"
    assert written[-1] == 19, f"final epoch not durable: {written}"
    assert len(written) < 20, "keep-up mode skipped nothing"
    assert written == sorted(written)
    # 20 blocking writes would take >= 1 s; keep-up mode must not.
    assert elapsed < 0.9, f"keep-up mode still backpressures: {elapsed:.2f}s"


def test_async_saver_default_saves_every_epoch(tmp_path, monkeypatch):
    """Default policy keeps reference semantics: every epoch written."""
    written = []
    monkeypatch.setattr(checkpoint, "save",
                        _slow_recording_save(written, delay=0.01))
    with checkpoint.AsyncSaver() as saver:
        for step in range(10):
            saver.save(str(tmp_path), step, {"w": step})
    assert written == list(range(10))


def test_async_saver_none_policy_writes_nothing(tmp_path, monkeypatch):
    """'none' policy (sweep mode): save() is a no-op — the policy lives
    entirely in AsyncSaver, not in per-call-site guards."""
    written = []
    monkeypatch.setattr(checkpoint, "save",
                        _slow_recording_save(written, delay=0.0))
    with checkpoint.AsyncSaver(policy="none") as saver:
        for step in range(5):
            saver.save(str(tmp_path), step, {"w": step})
    assert written == []


def test_async_saver_error_raised_once(tmp_path, monkeypatch):
    """A writer failure surfaces on the next save() exactly once (ADVICE
    r2 #3) — subsequent saves and close() proceed normally."""
    calls = {"n": 0}

    def failing_once(ckpt_dir, step, state):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("disk full")

    monkeypatch.setattr(checkpoint, "save", failing_once)
    saver = checkpoint.AsyncSaver()
    saver.save(str(tmp_path), 0, {})
    deadline = time.perf_counter() + 5.0
    while saver._err is None and time.perf_counter() < deadline:
        time.sleep(0.01)
    try:
        saver.save(str(tmp_path), 1, {})
        raise AssertionError("expected the writer failure to re-raise")
    except RuntimeError:
        pass
    saver.save(str(tmp_path), 2, {})  # err cleared: does not raise again
    # ... but the failure is STICKY at close(): a run with a missing
    # checkpoint epoch must not end reporting success (ADVICE r3).
    try:
        saver.close()
        raise AssertionError("expected close() to surface the sticky error")
    except RuntimeError as e:
        assert "earlier checkpoint write failed" in str(e)


# ---------------------------------------------------------------------------
# PGD training surface (VERDICT r2 missing #4 / next #8)
# ---------------------------------------------------------------------------

def _advp_batch(seed=0):
    rng = np.random.default_rng(seed)
    pts = jnp.asarray(rng.standard_normal((B, N, 3)).astype(np.float32))
    labels = jnp.asarray((np.arange(B) % 4).astype(np.int32))
    return pts, labels


def test_pgd_steps1_matches_fgsm_exactly():
    """--attack pgd --attack_steps 1 is FGSM (alpha=eps, projection a
    no-op) — the trainer routes it through the identical single-grad
    path, so losses are bitwise equal."""
    pts, labels = _advp_batch()
    base = dict(num_classes=4, batch_size=B, num_points=N, epsilon=0.05)
    cfg_f = AdvPerturbConfig(attack="fgsm", **base)
    cfg_p = AdvPerturbConfig(attack="pgd", attack_steps=1, **base)
    tx = adv_perturb.make_tx(cfg_f, 1)
    s0 = adv_perturb.create_state(cfg_f, 1)
    _, m_f = adv_perturb.train_step(s0, pts, labels, cfg=cfg_f, tx=tx)
    _, m_p = adv_perturb.train_step(s0, pts, labels, cfg=cfg_p, tx=tx)
    assert float(m_f["loss"]) == float(m_p["loss"])


def test_pgd_multi_step_runs_and_differs():
    """PGD with steps>1 compiles into the same jitted step (lax.fori_loop)
    and produces a different (iterated) perturbation than FGSM."""
    pts, labels = _advp_batch()
    base = dict(num_classes=4, batch_size=B, num_points=N, epsilon=0.05)
    cfg_f = AdvPerturbConfig(attack="fgsm", **base)
    cfg_p = AdvPerturbConfig(attack="pgd", attack_steps=4, **base)
    tx = adv_perturb.make_tx(cfg_f, 1)
    s0 = adv_perturb.create_state(cfg_f, 1)
    s_f, m_f = adv_perturb.train_step(s0, pts, labels, cfg=cfg_f, tx=tx)
    s_p, m_p = adv_perturb.train_step(s0, pts, labels, cfg=cfg_p, tx=tx)
    assert np.isfinite(float(m_p["loss"]))
    assert float(m_f["loss"]) != float(m_p["loss"])


def test_pgd_perturbation_stays_in_linf_ball():
    from adversarial_learning_on_pointclouds import attacks

    pts, labels = _advp_batch()
    eps = 0.03

    def loss(x):
        return jnp.sum(jnp.sin(x * 3.0))

    x_adv = attacks.iterated_fgsm_points(loss, pts, eps, steps=5,
                                         step_size=eps)  # deliberately big
    assert float(jnp.max(jnp.abs(x_adv - pts))) <= eps + 1e-6


# ---------------------------------------------------------------------------
# --supervised_only ablation baseline (VERDICT r2 missing #3 / next #1)
# ---------------------------------------------------------------------------

def test_supervised_only_step_freezes_d_and_drops_gan_terms():
    """--supervised_only: the step trains G with CE only — D params and
    optimizer state pass through untouched, adv/semi/D losses are zero,
    and loss_g == loss_ce."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.train import adversarial

    cfg = AdversarialConfig(num_parts=50, batch_size=B, num_points=N,
                            supervised_only=True, feature_transform=True)
    g_tx, d_tx = adversarial.make_txs(cfg, 1)
    state = adversarial.create_state(cfg, 1)
    rng = np.random.default_rng(0)
    x_l = jnp.asarray(rng.standard_normal((B, N, 3)).astype(np.float32))
    y_l = jnp.asarray(rng.integers(0, 50, (B, N)).astype(np.int32))
    x_u = jnp.asarray(rng.standard_normal((B, N, 3)).astype(np.float32))
    new_state, m = adversarial.train_step(state, x_l, y_l, x_u, cfg=cfg,
                                          g_tx=g_tx, d_tx=d_tx)
    assert float(m["loss_adv"]) == 0.0
    assert float(m["loss_semi"]) == 0.0
    assert float(m["loss_d"]) == 0.0
    assert float(m["loss_g"]) == float(m["loss_ce"])
    for a, b in zip(jax.tree_util.tree_leaves(state.d_params),
                    jax.tree_util.tree_leaves(new_state.d_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # G actually trained.
    changed = any(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(state.g_params),
                        jax.tree_util.tree_leaves(new_state.g_params)))
    assert changed


def test_supervised_only_matches_segment_ce_loss():
    """The supervised-only G objective equals the plain segmentation CE
    (+ft reg) on the same batch — the ablation baseline IS config-3's
    loss on the labeled subset."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds import losses
    from adversarial_learning_on_pointclouds.models import (
        apply_segmenter,
    )
    from adversarial_learning_on_pointclouds.train import adversarial
    from adversarial_learning_on_pointclouds.train.classify import (
        FT_REG_WEIGHT,
    )

    cfg = AdversarialConfig(num_parts=50, batch_size=B, num_points=N,
                            supervised_only=True, feature_transform=True)
    state = adversarial.create_state(cfg, 1)
    rng = np.random.default_rng(1)
    x_l = jnp.asarray(rng.standard_normal((B, N, 3)).astype(np.float32))
    y_l = jnp.asarray(rng.integers(0, 50, (B, N)).astype(np.int32))
    total, aux = adversarial._g_loss_fn(
        state.g_params, state.d_params, state.g_bn_state, x_l, y_l, x_l,
        cfg, jnp.float32(1.0))
    logp, _, tf, _ = apply_segmenter(state.g_params, state.g_bn_state,
                                     x_l, train=True)
    ref = losses.nll_loss(logp, y_l) + FT_REG_WEIGHT * \
        losses.orthogonality_reg(tf)
    assert float(total) == float(ref)


# ---------------------------------------------------------------------------
# --paired_heads cross-stream-batched T-Net fc heads (VERDICT r2 weak #1)
# ---------------------------------------------------------------------------

def _adv_batch(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x_l = jnp.asarray(rng.standard_normal((B, n, 3)).astype(np.float32))
    y_l = jnp.asarray(rng.integers(0, 50, (B, n)).astype(np.int32))
    x_u = jnp.asarray(rng.standard_normal((B, n, 3)).astype(np.float32))
    return x_l, y_l, x_u


def test_paired_heads_distinct_streams_match_sequential():
    """Per-stream grouped BN makes the paired path numerics-EXACT vs two
    sequential calls for ARBITRARY (distinct) streams: the head matmuls
    run batched [2B, 1024] but every batch-axis BN computes per-stream
    statistics with the EMA chained a -> b (core.batch_norm_grouped /
    the grouped epilogue kernel). Only fp-rounding (the BN centering
    constant of stream b) can differ; measured bitwise-equal here."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.train import adversarial

    x_l, y_l, x_u = _adv_batch()
    base = dict(num_parts=50, batch_size=B, num_points=N,
                feature_transform=True)
    cfg_seq = AdversarialConfig(paired_heads=False, **base)
    cfg_pair = AdversarialConfig(paired_heads=True, **base)
    state = adversarial.create_state(cfg_seq, 1)
    semi_on = jnp.float32(1.0)
    l_seq, aux_seq = adversarial._g_loss_fn(
        state.g_params, state.d_params, state.g_bn_state, x_l, y_l, x_u,
        cfg_seq, semi_on)
    l_pair, aux_pair = adversarial._g_loss_fn(
        state.g_params, state.d_params, state.g_bn_state, x_l, y_l, x_u,
        cfg_pair, semi_on)
    assert float(l_pair) == pytest.approx(float(l_seq), rel=1e-6)
    # The chained running-stat EMAs must agree too (head BNs update
    # per-stream, a then b, exactly like sequential calls).
    for k in ("stn", "fstn"):
        for bn in ("bn_fc1", "bn_fc2"):
            for stat in ("mean", "var"):
                a = np.asarray(aux_seq["bn"]["feat"][k][bn][stat])
                b = np.asarray(aux_pair["bn"]["feat"][k][bn][stat])
                scale = np.abs(a).max() + 1e-8
                assert np.abs(a - b).max() / scale < 1e-5, (k, bn, stat)


def test_paired_heads_grads_match_sequential_no_pallas():
    """G-gradient parity paired vs sequential on the jnp dispatch path
    (exercises core.batch_norm_grouped inside the full model backward)."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.ops import dispatch
    from adversarial_learning_on_pointclouds.train import adversarial

    x_l, y_l, x_u = _adv_batch(seed=9)
    # semi_on=0 kills the D-confidence threshold masks whose selections
    # flip under fp-level forward differences and discretely change the
    # gradient (same deterministic-selection trick as the tight DP grad
    # tests); the CE + adv + ortho terms remain fully exercised.
    base = dict(num_parts=50, batch_size=B, num_points=N,
                feature_transform=True, use_pallas=False)
    cfg_seq = AdversarialConfig(paired_heads=False, **base)
    cfg_pair = AdversarialConfig(paired_heads=True, **base)
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
        # Mixed bound: relative on real gradients (2e-3 ≈ 2.5x the
        # measured model-level fp-reassociation floor of 7.7e-4 through
        # batch-8 BN chains — see CLAUDE.md / the pallas-vs-jnp grad
        # parity test), absolute floor for the symbolically-zero leaves
        # (fc biases through batch-BN), whose values are pure fp noise
        # on both paths.
        scale = float(jnp.max(jnp.abs(a)))
        assert float(jnp.max(jnp.abs(a - b))) < 2e-3 * scale + 1e-6


def test_paired_heads_step_trains():
    """Full jitted G+D step under --paired_heads: runs, finite metrics,
    both nets update, and the distinct-stream loss matches the
    sequential step (per-stream grouped BN — fp-rounding-level only)."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.train import adversarial

    x_l, y_l, x_u = _adv_batch(seed=5)
    cfg = AdversarialConfig(num_parts=50, batch_size=B, num_points=N,
                            feature_transform=True, paired_heads=True)
    g_tx, d_tx = adversarial.make_txs(cfg, 1)
    state = adversarial.create_state(cfg, 1)
    new_state, m = adversarial.train_step(state, x_l, y_l, x_u, cfg=cfg,
                                          g_tx=g_tx, d_tx=d_tx)
    for k, v in m.items():
        assert np.isfinite(float(v)), k
    changed = any(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(state.g_params),
                        jax.tree_util.tree_leaves(new_state.g_params)))
    assert changed
    cfg_seq = AdversarialConfig(num_parts=50, batch_size=B, num_points=N,
                                feature_transform=True, paired_heads=False)
    _, m_seq = adversarial.train_step(state, x_l, y_l, x_u, cfg=cfg_seq,
                                      g_tx=g_tx, d_tx=d_tx)
    assert float(m["loss_g"]) == pytest.approx(float(m_seq["loss_g"]),
                                               rel=1e-4)


def test_paired_heads_no_pallas_path():
    """The paired path also works with the kernel route switched off
    (``--no_pallas``: pure-jnp dispatch everywhere)."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.ops import dispatch
    from adversarial_learning_on_pointclouds.train import adversarial

    x_l, y_l, x_u = _adv_batch(seed=6)
    cfg = AdversarialConfig(num_parts=50, batch_size=B, num_points=N,
                            feature_transform=True, paired_heads=True,
                            use_pallas=False)
    state = adversarial.create_state(cfg, 1)
    with dispatch.use_pallas(False):
        total, aux = adversarial._g_loss_fn(
            state.g_params, state.d_params, state.g_bn_state, x_l, y_l,
            x_u, cfg, jnp.float32(1.0))
    assert np.isfinite(float(total))


# ---------------------------------------------------------------------------
# --fused_epoch single-launch epoch program (VERDICT r2 weak #3 / next #3)
# ---------------------------------------------------------------------------

def test_fused_epoch_matches_stepwise(tmp_path):
    """--fused_epoch (spe train steps + whole eval scan in ONE program)
    reproduces the per-step path: same index streams, same RNG chain,
    same eval protocol — best mIoU and per-epoch metrics must agree to
    fp reordering tolerance."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.train import runner

    base = dict(labeled_ratio=0.5, batch_size=4, num_points=64,
                epochs=2, ckpt_policy="none", quiet=True, num_devices=1,
                feature_transform=False, scan=0, seed=3)
    r_step = runner.run_adversarial(AdversarialConfig(
        out_dir=str(tmp_path / "step"), **base))
    r_fused = runner.run_adversarial(AdversarialConfig(
        out_dir=str(tmp_path / "fused"), fused_epoch=True, **base))
    assert r_fused["best_miou"] == pytest.approx(r_step["best_miou"],
                                                 abs=1e-5)
    for k, v in r_step["category_miou"].items():
        assert r_fused["category_miou"][k] == pytest.approx(v, abs=1e-5)


def test_fused_epoch_single_net_matches_stepwise(tmp_path):
    """--fused_epoch on the single-network trainers (classification here;
    segmentation/adv-perturb share state_lib.epoch_program_fns) matches
    the per-step path."""
    from adversarial_learning_on_pointclouds.configs import (
        ClassifyConfig,
    )
    from adversarial_learning_on_pointclouds.train import runner

    base = dict(batch_size=4, num_points=64, epochs=2, num_classes=4,
                ckpt_policy="none", quiet=True, num_devices=1, seed=1)
    r_step = runner.run_classification(ClassifyConfig(
        out_dir=str(tmp_path / "step"), **base))
    r_fused = runner.run_classification(ClassifyConfig(
        out_dir=str(tmp_path / "fused"), fused_epoch=True, **base))
    assert r_fused["best_accuracy"] == pytest.approx(
        r_step["best_accuracy"], abs=1e-6)


def test_fused_epoch_rejects_host_data():
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.train import runner

    cfg = AdversarialConfig(fused_epoch=True, device_data=False,
                            batch_size=4, num_points=64, epochs=1)
    try:
        runner.run_adversarial(cfg)
        raise AssertionError("expected ValueError")
    except ValueError as e:
        assert "fused_epoch" in str(e)


# ---------------------------------------------------------------------------
# Grouped BatchNorm (per-stream statistics of the paired heads)
# ---------------------------------------------------------------------------

def test_batch_norm_grouped_matches_sequential():
    """batch_norm_grouped == two chained batch_norm calls on the row
    blocks: values, grads, and the chained EMA state (per-stream paired
    head semantics)."""
    from adversarial_learning_on_pointclouds.models import core

    rng = np.random.default_rng(11)
    G, Bx, C = 2, 8, 16
    x = jnp.asarray(rng.standard_normal((G * Bx, C)).astype(np.float32)
                    * 2 + 0.5)
    w = jnp.asarray(rng.standard_normal((G * Bx, C)).astype(np.float32))
    p = {"scale": jnp.asarray(rng.standard_normal(C).astype(np.float32)),
         "bias": jnp.asarray(rng.standard_normal(C).astype(np.float32))}
    s = {"mean": jnp.asarray(
            0.1 * rng.standard_normal(C).astype(np.float32)),
         "var": jnp.ones((C,), jnp.float32) + 0.3}

    def f_seq(x):
        ya, sa = core.batch_norm(p, s, x[:Bx], True)
        yb, sb = core.batch_norm(p, sa, x[Bx:], True)
        return (jnp.concatenate([ya, yb], 0) * w).sum(), sb

    def f_grp(x):
        y, ns = core.batch_norm_grouped(p, s, x, True, G)
        return (y * w).sum(), ns

    (vs, ss), gs = jax.value_and_grad(f_seq, has_aux=True)(x)
    (vg, sg), gg = jax.value_and_grad(f_grp, has_aux=True)(x)
    assert float(vg) == pytest.approx(float(vs), rel=1e-5)
    assert float(jnp.max(jnp.abs(gs - gg))) / float(
        jnp.max(jnp.abs(gs))) < 1e-5
    for k in ("mean", "var"):
        np.testing.assert_allclose(np.asarray(sg[k]), np.asarray(ss[k]),
                                   rtol=1e-5, atol=1e-7)
    # groups=1 defers to batch_norm bitwise.
    y1, s1 = core.batch_norm_grouped(p, s, x, True, 1)
    y0, s0 = core.batch_norm(p, s, x, True)
    assert np.array_equal(np.asarray(y1), np.asarray(y0))


# ---------------------------------------------------------------------------
# CLI flag surface
# ---------------------------------------------------------------------------

def test_new_flags_parse():
    cfg = adv_perturb_config_from_args(
        ["--attack", "pgd", "--attack_steps", "7", "--ckpt_policy",
         "latest", "--log_lag", "0"])
    assert cfg.attack == "pgd" and cfg.attack_steps == 7
    assert cfg.ckpt_policy == "latest" and cfg.log_lag == 0
    cfg2 = classify_config_from_args([])
    assert cfg2.ckpt_policy == "every" and cfg2.log_lag == 2


def test_paired_heads_default_on_with_escape():
    """--paired_heads is the adversarial default since the grouped-BN
    rework made it numerics-exact; --no_paired_heads restores the
    sequential per-stream heads; both flags share one dest so the last
    one passed wins (ADVICE r3 — the full matrix is pinned in
    test_round4.test_paired_heads_flag_pair)."""
    from adversarial_learning_on_pointclouds.configs import (
        adversarial_config_from_args,
    )
    assert adversarial_config_from_args([]).paired_heads
    assert not adversarial_config_from_args(
        ["--no_paired_heads"]).paired_heads
    assert not adversarial_config_from_args(
        ["--paired_heads", "--no_paired_heads"]).paired_heads


def test_paired_heads_odd_batch_uses_xla_grouped_path():
    """Per-stream batches that are not multiples of 8 (b % 8 != 0) match
    the sequential path through the grouped-BN heads — paired_heads is
    the DEFAULT, so odd --batchSize values the sequential path accepted
    must keep working."""
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.train import adversarial

    b_odd = 12  # not a multiple of 8
    rng = np.random.default_rng(3)
    x_l = jnp.asarray(rng.standard_normal((b_odd, N, 3)).astype(np.float32))
    y_l = jnp.asarray(rng.integers(0, 50, (b_odd, N)).astype(np.int32))
    x_u = jnp.asarray(rng.standard_normal((b_odd, N, 3)).astype(np.float32))
    base = dict(num_parts=50, batch_size=b_odd, num_points=N,
                feature_transform=True)
    state = adversarial.create_state(
        AdversarialConfig(paired_heads=False, **base), 1)
    semi_on = jnp.float32(1.0)
    l_seq, _ = adversarial._g_loss_fn(
        state.g_params, state.d_params, state.g_bn_state, x_l, y_l, x_u,
        AdversarialConfig(paired_heads=False, **base), semi_on)
    l_pair, _ = adversarial._g_loss_fn(
        state.g_params, state.d_params, state.g_bn_state, x_l, y_l, x_u,
        AdversarialConfig(paired_heads=True, **base), semi_on)
    assert float(l_pair) == pytest.approx(float(l_seq), rel=1e-5)
