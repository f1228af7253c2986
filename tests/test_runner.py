"""End-to-end runner smoke tests: the full epoch loops (data -> sharded
batches -> jitted steps -> eval -> checkpoint -> logs) on tiny configs."""

import os

import numpy as np

from adversarial_learning_on_pointclouds.configs import (
    AdversarialConfig, AdvPerturbConfig, ClassifyConfig, SegmentConfig,
)
from adversarial_learning_on_pointclouds.train import runner


def test_run_classification(modelnet_root, tmp_path):
    cfg = ClassifyConfig(batch_size=8, num_points=64, epochs=2,
                         out_dir=str(tmp_path / "cls"), augment=True,
                         dataset=modelnet_root, use_pallas=False, quiet=True)
    result = runner.run_classification(cfg)
    assert 0.0 <= result["best_accuracy"] <= 1.0
    assert os.path.isdir(os.path.join(cfg.out_dir, "1"))
    csv = os.path.join(cfg.out_dir, "cls_metrics.csv")
    assert os.path.getsize(csv) > 0
    with open(csv) as f:
        header = f.readline()
    assert "points_per_sec_per_chip" in header


def test_run_segmentation(shapenet_root, tmp_path):
    cfg = SegmentConfig(batch_size=8, num_points=64, epochs=1,
                        out_dir=str(tmp_path / "seg"),
                        dataset=shapenet_root, use_pallas=False, quiet=True,
                        feature_transform=False)
    result = runner.run_segmentation(cfg)
    assert 0.0 <= result["best_miou"] <= 1.0
    assert isinstance(result["category_miou"], dict)


def test_run_adversarial(shapenet_root, tmp_path):
    cfg = AdversarialConfig(batch_size=8, num_points=64, epochs=1,
                            out_dir=str(tmp_path / "adv"),
                            dataset=shapenet_root, use_pallas=False,
                            quiet=True, feature_transform=False)
    result = runner.run_adversarial(cfg)
    assert 0.0 <= result["best_miou"] <= 1.0
    state = result["state"]
    assert int(state.step) > 0


def test_adversarial_device_data_matches_host_path(shapenet_root, tmp_path):
    """The (default) device-resident pool + on-device gather path trains
    IDENTICALLY to host-assembled batch streaming: same index streams,
    same rows, same RNG — final params must match exactly."""
    import jax

    kw = dict(batch_size=8, num_points=64, epochs=2, dataset=shapenet_root,
              use_pallas=False, quiet=True, feature_transform=False,
              augment=True)
    r_dev = runner.run_adversarial(AdversarialConfig(
        out_dir=str(tmp_path / "adv_dev"), device_data=True, **kw))
    r_host = runner.run_adversarial(AdversarialConfig(
        out_dir=str(tmp_path / "adv_host"), device_data=False, **kw))
    for a, b in zip(jax.tree_util.tree_leaves(r_dev["state"].g_params),
                    jax.tree_util.tree_leaves(r_host["state"].g_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert r_dev["best_miou"] == r_host["best_miou"]


def test_adversarial_device_data_scan_matches_host_path(shapenet_root,
                                                        tmp_path):
    """Same contract through the --scan K fused-launch path (stacked [K,B]
    index transfers + lax.scan gather steps)."""
    import jax

    kw = dict(batch_size=8, num_points=64, epochs=1, dataset=shapenet_root,
              use_pallas=False, quiet=True, feature_transform=False)
    r_scan = runner.run_adversarial(AdversarialConfig(
        out_dir=str(tmp_path / "adv_scan_dev"), device_data=True, scan=2,
        **kw))
    r_host = runner.run_adversarial(AdversarialConfig(
        out_dir=str(tmp_path / "adv_scan_host"), device_data=False, **kw))
    for a, b in zip(jax.tree_util.tree_leaves(r_scan["state"].g_params),
                    jax.tree_util.tree_leaves(r_host["state"].g_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_run_adv_perturb(modelnet_root, tmp_path):
    cfg = AdvPerturbConfig(batch_size=8, num_points=64, epochs=1,
                           out_dir=str(tmp_path / "advp"),
                           dataset=modelnet_root, use_pallas=False,
                           quiet=True, epsilon=0.03)
    result = runner.run_adv_perturb(cfg)
    assert 0.0 <= result["best_accuracy"] <= 1.0


def test_resume_from_checkpoint(modelnet_root, tmp_path):
    out = str(tmp_path / "cls_resume")
    cfg = ClassifyConfig(batch_size=8, num_points=64, epochs=1,
                         out_dir=out, dataset=modelnet_root,
                         use_pallas=False, quiet=True)
    r1 = runner.run_classification(cfg)
    p1 = np.asarray(
        r1["state"].params["fc3"]["w"] if "fc3" in r1["state"].params
        else r1["state"].params["fc1"]["w"])
    cfg2 = ClassifyConfig(batch_size=8, num_points=64, epochs=1,
                          out_dir=str(tmp_path / "cls_resume2"),
                          dataset=modelnet_root, use_pallas=False,
                          quiet=True, resume=out)
    r2 = runner.run_classification(cfg2)
    # Warm start happened: epoch-0 eval of run 2 should differ from random
    # init (we just check it ran and produced different params than run 1,
    # i.e. continued training).
    p2 = np.asarray(
        r2["state"].params["fc3"]["w"] if "fc3" in r2["state"].params
        else r2["state"].params["fc1"]["w"])
    assert p1.shape == p2.shape
    assert not np.array_equal(p1, p2)


def test_classification_device_data_matches_host_path(modelnet_root,
                                                      tmp_path):
    """Single-network gather path (state_lib.gather_step_fns): the
    device-resident pool + on-device row selection must train
    bit-identically to host-assembled streaming, incl. with --scan K."""
    import jax

    kw = dict(batch_size=8, num_points=64, epochs=2, dataset=modelnet_root,
              use_pallas=False, quiet=True, augment=True)
    r_dev = runner.run_classification(ClassifyConfig(
        out_dir=str(tmp_path / "c_dev"), device_data=True, **kw))
    r_scan = runner.run_classification(ClassifyConfig(
        out_dir=str(tmp_path / "c_scan"), device_data=True, scan=2, **kw))
    r_host = runner.run_classification(ClassifyConfig(
        out_dir=str(tmp_path / "c_host"), device_data=False, **kw))
    for r in (r_dev, r_scan):
        for a, b in zip(jax.tree_util.tree_leaves(r["state"].params),
                        jax.tree_util.tree_leaves(r_host["state"].params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert r["best_accuracy"] == r_host["best_accuracy"]


def test_segmentation_device_data_matches_host_path(shapenet_root,
                                                    tmp_path):
    import jax

    kw = dict(batch_size=8, num_points=64, epochs=1, dataset=shapenet_root,
              use_pallas=False, quiet=True, feature_transform=False)
    r_dev = runner.run_segmentation(SegmentConfig(
        out_dir=str(tmp_path / "s_dev"), device_data=True, scan=2, **kw))
    r_host = runner.run_segmentation(SegmentConfig(
        out_dir=str(tmp_path / "s_host"), device_data=False, **kw))
    for a, b in zip(jax.tree_util.tree_leaves(r_dev["state"].params),
                    jax.tree_util.tree_leaves(r_host["state"].params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert r_dev["best_miou"] == r_host["best_miou"]


def test_adv_perturb_device_data_matches_host_path(modelnet_root, tmp_path):
    import jax

    kw = dict(batch_size=8, num_points=64, epochs=1, dataset=modelnet_root,
              use_pallas=False, quiet=True, epsilon=0.05)
    r_dev = runner.run_adv_perturb(AdvPerturbConfig(
        out_dir=str(tmp_path / "p_dev"), device_data=True, scan=2, **kw))
    r_host = runner.run_adv_perturb(AdvPerturbConfig(
        out_dir=str(tmp_path / "p_host"), device_data=False, **kw))
    for a, b in zip(jax.tree_util.tree_leaves(r_dev["state"].params),
                    jax.tree_util.tree_leaves(r_host["state"].params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_adv_perturb_pallas_eval_attack_path(modelnet_root, tmp_path):
    """Regression: with the kernel route on, the FGSM attack
    differentiates through the eval-mode forward; the eval trunk-exit
    kernel has no VJP, so the attack section must force the plain path
    (adv_perturb._train_step_impl) instead of failing to differentiate
    the kernel. Runs the kernel in interpret mode; the runner's own path
    (use_pallas=True, the CLI default) runs too."""
    import jax

    from adversarial_learning_on_pointclouds.ops import use_pallas
    from adversarial_learning_on_pointclouds.train import adv_perturb

    cfg = AdvPerturbConfig(batch_size=4, num_points=64, epsilon=0.05)
    tx = adv_perturb.make_tx(cfg, 1)
    state = adv_perturb.create_state(cfg, 1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 64, 3)).astype(np.float32)
    y = rng.integers(0, 40, 4).astype(np.int32)
    with use_pallas(interpret=True):
        _, m = adv_perturb.train_step(state, x, y, cfg=cfg, tx=tx)
    assert all(np.isfinite(float(v)) for v in jax.tree_util.tree_leaves(m))

    cfg = AdvPerturbConfig(batch_size=8, num_points=64, epochs=1,
                           out_dir=str(tmp_path / "advp_pallas"),
                           dataset=modelnet_root, use_pallas=True,
                           quiet=True, epsilon=0.05)
    result = runner.run_adv_perturb(cfg)
    assert 0.0 <= result["best_accuracy"] <= 1.0


def test_eval_cli_scripts_in_process(modelnet_root, shapenet_root,
                                     tmp_path, monkeypatch, capsys):
    """The three eval CLI surfaces (classification, segmentation,
    robustness) run against fresh 1-epoch checkpoints — in-process so the
    conftest CPU mesh applies; covers arg parsing, checkpoint restore,
    and the report formatting end-to-end."""
    import sys

    from scripts import (
        eval_classification, eval_robustness, eval_segmentation,
    )

    cls_dir = str(tmp_path / "cls")
    runner.run_classification(ClassifyConfig(
        batch_size=8, num_points=64, epochs=1, out_dir=cls_dir,
        dataset=modelnet_root, use_pallas=False, quiet=True))
    monkeypatch.setattr(sys, "argv", [
        "eval_classification.py", "--model", cls_dir, "--dataset",
        modelnet_root, "--batchSize", "8", "--num_points", "64",
        "--no_pallas"])
    eval_classification.main()
    out = capsys.readouterr().out
    assert "accuracy" in out

    seg_dir = str(tmp_path / "seg")
    runner.run_segmentation(SegmentConfig(
        batch_size=8, num_points=64, epochs=1, out_dir=seg_dir,
        dataset=shapenet_root, use_pallas=False, quiet=True))
    ply_dir = str(tmp_path / "ply")
    monkeypatch.setattr(sys, "argv", [
        "eval_segmentation.py", "--model", seg_dir, "--dataset",
        shapenet_root, "--batchSize", "8", "--num_points", "64",
        "--no_pallas", "--export_ply", ply_dir])
    eval_segmentation.main()
    out = capsys.readouterr().out
    assert "mIoU" in out or "miou" in out
    assert os.listdir(ply_dir)

    monkeypatch.setattr(sys, "argv", [
        "eval_robustness.py", "--model", cls_dir, "--dataset",
        modelnet_root, "--batchSize", "8", "--num_points", "64",
        "--epsilons", "0.0", "0.05"])
    eval_robustness.main()
    out = capsys.readouterr().out
    assert "eps" in out


def test_train_cli_scripts_in_process(modelnet_root, shapenet_root,
                                      tmp_path, monkeypatch, capsys):
    """The four train CLI surfaces end-to-end on tiny configs (in-process
    so the conftest CPU mesh applies): reference flag names -> config ->
    runner -> final report line."""
    import sys

    from scripts import (
        train_adv_perturb, train_adversarial, train_classification,
        train_segmentation,
    )

    runs = [
        (train_classification, "final best accuracy", [
            "--dataset", modelnet_root, "--outf", str(tmp_path / "c")]),
        (train_segmentation, "final best instance mIoU", [
            "--dataset", shapenet_root, "--outf", str(tmp_path / "s")]),
        (train_adversarial, "final best", [
            "--dataset", shapenet_root, "--outf", str(tmp_path / "a"),
            "--labeled_ratio", "0.5"]),
        (train_adv_perturb, "final best accuracy", [
            "--dataset", modelnet_root, "--outf", str(tmp_path / "p"),
            "--epsilon", "0.05"]),
    ]
    for mod, needle, extra in runs:
        monkeypatch.setattr(sys, "argv", [
            mod.__name__.split(".")[-1] + ".py", "--nepoch", "1",
            "--batchSize", "8", "--num_points", "64", "--no_pallas",
            "--quiet"] + extra)
        mod.main()
        out = capsys.readouterr().out
        assert needle in out, (mod.__name__, out[-500:])
