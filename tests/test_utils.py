"""Tests for the smaller utility modules: ply export, metric logger,
profiling contexts, configs CLI shims, PGD attack."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adversarial_learning_on_pointclouds import attacks, configs
from adversarial_learning_on_pointclouds.utils import ply
from adversarial_learning_on_pointclouds.utils.logging import MetricLogger
from adversarial_learning_on_pointclouds.utils.profiling import debug_nans


def test_ply_roundtrip(tmp_path):
    pts = np.random.default_rng(0).standard_normal((32, 3)).astype(np.float32)
    labels = np.arange(32) % 5
    path = str(tmp_path / "x.ply")
    ply.write_ply_with_labels(path, pts, labels)
    back = ply.read_ply(path)
    np.testing.assert_allclose(back, pts, atol=1e-5)
    # colors cycle the palette by label
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "ply"
    assert f"element vertex 32" in "\n".join(lines[:5])


def test_metric_logger_csv(tmp_path):
    lg = MetricLogger(str(tmp_path), "run", quiet=True)
    for step in range(3):
        lg.log_step(0, step, 3, step, {"loss": 1.0 / (step + 1)},
                    points_per_step=1024, num_chips=1)
    lg.log_epoch(0, accuracy=0.5)
    lg.close()
    with open(tmp_path / "run_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3
    assert float(rows[0]["loss"]) == 1.0
    assert "points_per_sec_per_chip" in rows[0]
    assert float(rows[1]["points_per_sec_per_chip"]) > 0


def test_metric_logger_lag_defers_then_flushes(tmp_path):
    """With lag=2, readback/rows trail 2 steps behind; log_epoch/close
    drain the queue so no row is ever lost (pipeline-overlap contract)."""

    class Tracked:
        """Scalar that records when it is materialized."""
        def __init__(self, v, sink):
            self.v, self.sink = v, sink

        def __float__(self):
            self.sink.append(self.v)
            return float(self.v)

    seen = []
    lg = MetricLogger(str(tmp_path), "lagrun", quiet=True, lag=2)
    for step in range(4):
        lg.log_step(0, step, 4, step, {"loss": Tracked(step, seen)})
        # After enqueueing step k, at most k-1 older rows materialized.
        assert len(seen) == max(step - 1, 0)
    lg.log_epoch(0, accuracy=1.0)  # drains the 2 pending rows
    assert seen == [0, 1, 2, 3]
    lg.close()
    with open(tmp_path / "lagrun_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [float(r["loss"]) for r in rows] == [0.0, 1.0, 2.0, 3.0]


def test_debug_nans_context():
    prev = jax.config.jax_debug_nans
    with debug_nans(True):
        assert jax.config.jax_debug_nans is True
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.asarray(-1.0)).block_until_ready()
    assert jax.config.jax_debug_nans == prev


def test_cli_shims_parse_reference_flags():
    cfg = configs.classify_config_from_args(
        ["--batchSize", "16", "--num_points", "512", "--nepoch", "5",
         "--outf", "out", "--feature_transform", "--augment",
         "--manualSeed", "7", "--bf16"])
    assert cfg.batch_size == 16 and cfg.num_points == 512
    assert cfg.epochs == 5 and cfg.out_dir == "out"
    assert cfg.feature_transform and cfg.augment and cfg.bf16
    assert cfg.seed == 7

    acfg = configs.adversarial_config_from_args(
        ["--lambda_adv", "0.02", "--lambda_semi", "0.2",
         "--threshold", "0.3", "--labeled_ratio", "0.25",
         "--lr_D", "2e-4", "--class_choice", "Chair"])
    assert acfg.lambda_adv == pytest.approx(0.02)
    assert acfg.lambda_semi == pytest.approx(0.2)
    assert acfg.semi_threshold == pytest.approx(0.3)
    assert acfg.labeled_ratio == pytest.approx(0.25)
    assert acfg.lr_d == pytest.approx(2e-4)
    assert acfg.class_choice == "Chair"
    assert acfg.num_points == 2048  # seg default

    pcfg = configs.adv_perturb_config_from_args(["--epsilon", "0.1"])
    assert pcfg.epsilon == pytest.approx(0.1)
    assert pcfg.num_points == 1024  # cls default


def test_pgd_attack_stays_in_ball():
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 32, 3))

    def loss(z):
        return jnp.sum(jnp.sin(z) ** 2)

    x_adv = attacks.iterated_fgsm_points(loss, x, epsilon=0.03, steps=5)
    delta = np.abs(np.asarray(x_adv - x))
    assert delta.max() <= 0.03 + 1e-6
    assert delta.max() > 0.0
    # PGD with 1 step == FGSM with step size eps.
    a = attacks.iterated_fgsm_points(loss, x, 0.03, 1)
    b = attacks.fgsm_points(loss, x, 0.03)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_synthetic_modelnet_schema(tmp_path):
    """Fixture files carry the exact documented real-dataset schema."""
    import h5py

    from adversarial_learning_on_pointclouds.data.modelnet40 import (
        make_synthetic_modelnet_h5,
    )
    root = make_synthetic_modelnet_h5(str(tmp_path), 8, 4, 128)
    with h5py.File(os.path.join(root, "ply_data_train0.h5")) as f:
        assert f["data"].dtype == np.float32
        assert f["data"].shape[1:] == (128, 3)
        assert f["label"].dtype == np.uint8
        assert f["label"].shape[1] == 1


def test_render_cloud_script(shapenet_root, tmp_path):
    """Headless PNG renderer (the reference viewer's offline analogue)."""
    import os
    import subprocess
    import sys

    out = str(tmp_path / "r.png")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts", "render_cloud.py"),
         "--dataset", shapenet_root, "--index", "1", "--out", out],
        env=env, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert os.path.getsize(out) > 5000


def test_metric_logger_epoch_csv(tmp_path):
    """log_epoch persists a per-epoch CSV (the row post-hoc analysis
    reads; previously epoch summaries were stdout-only despite the docs
    claiming per-epoch CSV)."""
    lg = MetricLogger(str(tmp_path), "run", quiet=True)
    lg.log_epoch(0, instance_miou=0.5, train_s=1.25)
    lg.log_epoch(1, instance_miou=0.625, train_s=1.5)
    lg.close()
    with open(os.path.join(str(tmp_path), "run_epochs.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert float(rows[1]["instance_miou"]) == 0.625
