"""CLI-level reference ``.pth`` warm start (``--model model_24.pth``).

The reference warm-starts training from its per-epoch
``torch.save(state_dict)`` files via the ``--model`` flag
(SURVEY.md §2.10 "resume via --model flag + load_state_dict"). The
import/export translators existed as an API
(``utils/torch_import.py`` / ``torch_export.py``); these tests pin the
user-facing wiring: a ``*.pth`` path given to ``--model`` (cfg.resume)
loads params+BN and restarts the optimizer, on every trainer, with
readable errors on template mismatches.
"""

import jax
import numpy as np
import pytest

from adversarial_learning_on_pointclouds.configs import (
    AdversarialConfig,
    ClassifyConfig,
    SegmentConfig,
)
from adversarial_learning_on_pointclouds.train import (
    adversarial,
    classify,
    runner,
    segment,
)
from adversarial_learning_on_pointclouds.utils import (
    checkpoint,
    torch_export,
)


def _assert_trees_equal(a, b):
    jax.tree_util.tree_map(
        lambda x, y: np.testing.assert_array_equal(np.asarray(x),
                                                   np.asarray(y)), a, b)


def _assert_trees_differ(a, b):
    same = all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))
    assert not same


def test_classifier_pth_warm_start(tmp_path):
    cfg = ClassifyConfig(num_points=64, num_classes=7,
                         feature_transform=True)
    src = classify.create_state(cfg, 4, rng=jax.random.PRNGKey(3))
    path = str(tmp_path / "cls.pth")
    torch_export.save_pth(path, torch_export.classifier_state_dict(
        jax.device_get(src.params), jax.device_get(src.bn_state)))

    tmpl = classify.create_state(cfg, 4, rng=jax.random.PRNGKey(9))
    _assert_trees_differ(tmpl.params, src.params)  # distinct init
    out = checkpoint.load_params_only(path, tmpl)
    _assert_trees_equal(out.params, src.params)
    _assert_trees_equal(out.bn_state, src.bn_state)
    # Optimizer state / step / RNG stay fresh (reference --model
    # semantics: the lineage never saves optimizer state).
    _assert_trees_equal(out.opt_state, tmpl.opt_state)
    assert int(out.step) == int(tmpl.step)


def test_segmenter_pth_warm_start(tmp_path):
    cfg = SegmentConfig(num_points=64, num_parts=11,
                        feature_transform=False)
    src = segment.create_state(cfg, 4, rng=jax.random.PRNGKey(5))
    path = str(tmp_path / "seg.pth")
    torch_export.save_pth(path, torch_export.segmenter_state_dict(
        jax.device_get(src.params), jax.device_get(src.bn_state)))

    out = checkpoint.load_params_only(
        path, segment.create_state(cfg, 4, rng=jax.random.PRNGKey(6)))
    _assert_trees_equal(out.params, src.params)
    _assert_trees_equal(out.bn_state, src.bn_state)


def test_adversarial_pth_warm_start(tmp_path):
    cfg = AdversarialConfig(num_points=64, num_parts=11,
                            feature_transform=True)
    src = adversarial.create_state(cfg, 4, rng=jax.random.PRNGKey(7))
    path = str(tmp_path / "adv.pth")
    torch_export.save_pth(path, torch_export.segmenter_state_dict(
        jax.device_get(src.g_params), jax.device_get(src.g_bn_state)))

    # Without the _D companion: G loads, D keeps its fresh init (the
    # reference checkpoints G and D as separate files).
    tmpl = adversarial.create_state(cfg, 4, rng=jax.random.PRNGKey(8))
    out = checkpoint.load_params_only(path, tmpl)
    _assert_trees_equal(out.g_params, src.g_params)
    _assert_trees_equal(out.g_bn_state, src.g_bn_state)
    _assert_trees_equal(out.d_params, tmpl.d_params)

    # With the companion written by export_pth --arch adv: D loads too.
    torch_export.save_pth(
        str(tmp_path / "adv_D.pth"),
        torch_export.discriminator_state_dict(jax.device_get(src.d_params)))
    out2 = checkpoint.load_params_only(path, tmpl)
    _assert_trees_equal(out2.d_params, src.d_params)


def test_load_pth_generator_checked(tmp_path):
    """The generator-only .pth loader (adv inference/eval path) returns
    checked (g_params, g_bn_state) and rejects a template mismatch with
    the readable error instead of a later apply-time shape error."""
    cfg = AdversarialConfig(num_points=64, num_parts=11,
                            feature_transform=True)
    src = adversarial.create_state(cfg, 4, rng=jax.random.PRNGKey(9))
    path = str(tmp_path / "g.pth")
    torch_export.save_pth(path, torch_export.segmenter_state_dict(
        jax.device_get(src.g_params), jax.device_get(src.g_bn_state)))

    params, bn = checkpoint.load_pth_generator(
        path, adversarial.create_state(cfg, 4, rng=jax.random.PRNGKey(10)))
    _assert_trees_equal(params, src.g_params)
    _assert_trees_equal(bn, src.g_bn_state)

    wrong = AdversarialConfig(num_points=64, num_parts=13,
                              feature_transform=True)
    with pytest.raises(ValueError, match="num_parts"):
        checkpoint.load_pth_generator(
            path, adversarial.create_state(wrong, 4))


def test_pth_arch_mismatch_raises(tmp_path):
    seg_cfg = SegmentConfig(num_points=64, num_parts=11)
    seg_state = segment.create_state(seg_cfg, 4)
    path = str(tmp_path / "seg.pth")
    torch_export.save_pth(path, torch_export.segmenter_state_dict(
        jax.device_get(seg_state.params), jax.device_get(seg_state.bn_state)))

    cls_tmpl = classify.create_state(
        ClassifyConfig(num_points=64, num_classes=7), 4)
    with pytest.raises(ValueError, match="template"):
        checkpoint.load_params_only(path, cls_tmpl)


def test_pth_feature_transform_mismatch_raises(tmp_path):
    cfg_no_ft = ClassifyConfig(num_points=64, num_classes=7,
                               feature_transform=False)
    src = classify.create_state(cfg_no_ft, 4)
    path = str(tmp_path / "cls.pth")
    torch_export.save_pth(path, torch_export.classifier_state_dict(
        jax.device_get(src.params), jax.device_get(src.bn_state)))

    cfg_ft = ClassifyConfig(num_points=64, num_classes=7,
                            feature_transform=True)
    with pytest.raises(ValueError, match="feature_transform"):
        checkpoint.load_params_only(path, classify.create_state(cfg_ft, 4))


def test_resume_full_from_pth_raises(tmp_path):
    cfg = ClassifyConfig(num_points=64, num_classes=7)
    src = classify.create_state(cfg, 4)
    path = str(tmp_path / "cls.pth")
    torch_export.save_pth(path, torch_export.classifier_state_dict(
        jax.device_get(src.params), jax.device_get(src.bn_state)))
    with pytest.raises(ValueError, match="resume_full"):
        checkpoint.restore(path, src)


def test_infer_cli_from_pth(tmp_path, monkeypatch, capsys):
    """scripts/infer.py --checkpoint foo.pth (the reference's
    show_cls/show_seg usage: load the .pth and predict)."""
    import h5py

    from scripts import infer

    rng = np.random.default_rng(0)
    h5 = tmp_path / "clouds.h5"
    with h5py.File(h5, "w") as f:
        f.create_dataset("data", data=rng.standard_normal(
            (2, 80, 3)).astype(np.float32))

    cfg = ClassifyConfig(num_points=64, num_classes=7,
                         feature_transform=True)
    st = classify.create_state(cfg, 1)
    cls_pth = str(tmp_path / "cls.pth")
    torch_export.save_pth(cls_pth, torch_export.classifier_state_dict(
        jax.device_get(st.params), jax.device_get(st.bn_state)))
    monkeypatch.setattr("sys.argv", [
        "infer.py", "--checkpoint", cls_pth, "--model", "cls",
        "--input", str(h5), "--num_points", "64", "--num_classes", "7",
        "--feature_transform", "--no_pallas"])
    infer.main()
    assert capsys.readouterr().out.count("class") == 2

    acfg = AdversarialConfig(num_points=64, num_parts=9,
                             feature_transform=False)
    gst = adversarial.create_state(acfg, 1)
    adv_pth = str(tmp_path / "adv.pth")
    torch_export.save_pth(adv_pth, torch_export.segmenter_state_dict(
        jax.device_get(gst.g_params), jax.device_get(gst.g_bn_state)))
    monkeypatch.setattr("sys.argv", [
        "infer.py", "--checkpoint", adv_pth, "--model", "adv",
        "--input", str(h5), "--num_points", "64", "--num_parts", "9",
        "--no_pallas"])
    infer.main()
    assert "parts {" in capsys.readouterr().out


def test_runner_warm_starts_from_pth(modelnet_root, tmp_path):
    """E2E through the CLI config path: ``--model foo.pth`` + lr=0 — the
    trained params must equal the .pth exactly (Adam at lr 0 applies a
    zero update, so any deviation means the warm start didn't take)."""
    cfg = ClassifyConfig(batch_size=8, num_points=64, epochs=1,
                         out_dir=str(tmp_path / "warm_src"),
                         dataset=modelnet_root, use_pallas=False,
                         quiet=True)
    src = runner.run_classification(cfg)["state"]
    path = str(tmp_path / "warm.pth")
    torch_export.save_pth(path, torch_export.classifier_state_dict(
        jax.device_get(src.params), jax.device_get(src.bn_state)))

    cfg2 = ClassifyConfig(batch_size=8, num_points=64, epochs=1, lr=0.0,
                          out_dir=str(tmp_path / "warm_dst"),
                          dataset=modelnet_root, use_pallas=False,
                          quiet=True, resume=path)
    out = runner.run_classification(cfg2)["state"]
    _assert_trees_equal(out.params, src.params)


def test_eval_cli_from_pth_and_split(modelnet_root, tmp_path, monkeypatch,
                                     capsys):
    """The eval CLIs accept ``--model foo.pth`` (reference checkpoint
    format) and ``--split`` (reference eval scripts choose their split
    file); ``--split train`` must flow through to the loader."""
    from scripts import eval_classification

    cfg = ClassifyConfig(num_points=64, num_classes=40)
    st = classify.create_state(cfg, 1)
    pth = str(tmp_path / "cls40.pth")
    torch_export.save_pth(pth, torch_export.classifier_state_dict(
        jax.device_get(st.params), jax.device_get(st.bn_state)))

    monkeypatch.setattr("sys.argv", [
        "eval_classification.py", "--model", pth, "--dataset",
        modelnet_root, "--batchSize", "8", "--num_points", "64",
        "--split", "train", "--no_pallas"])
    eval_classification.main()
    out = capsys.readouterr().out
    assert "accuracy" in out

    # A split with no files errors loudly instead of silently evaluating
    # the test split.
    monkeypatch.setattr("sys.argv", [
        "eval_classification.py", "--model", pth, "--dataset",
        modelnet_root, "--batchSize", "8", "--num_points", "64",
        "--split", "val", "--no_pallas"])
    with pytest.raises((FileNotFoundError, OSError, ValueError)):
        eval_classification.main()


def test_eval_segmentation_cli_from_pth_and_split(shapenet_root, tmp_path,
                                                  monkeypatch, capsys):
    from scripts import eval_segmentation

    cfg = SegmentConfig(num_points=64)  # default 50-part global space
    st = segment.create_state(cfg, 1)
    pth = str(tmp_path / "seg.pth")
    torch_export.save_pth(pth, torch_export.segmenter_state_dict(
        jax.device_get(st.params), jax.device_get(st.bn_state)))

    # The synthetic ShapeNet fixture ships all three reference splits
    # (train/val/test); --split val must reach the loader.
    monkeypatch.setattr("sys.argv", [
        "eval_segmentation.py", "--model", pth, "--dataset",
        shapenet_root, "--batchSize", "8", "--num_points", "64",
        "--split", "val", "--no_pallas"])
    eval_segmentation.main()
    out = capsys.readouterr().out
    assert "mIoU" in out or "miou" in out

    # --adversarial accepts the same .pth: the G weights load through
    # load_pth_generator (a reference adversarial run checkpoints its
    # segmenter-G in the plain segmenter format).
    monkeypatch.setattr("sys.argv", [
        "eval_segmentation.py", "--model", pth, "--dataset",
        shapenet_root, "--batchSize", "8", "--num_points", "64",
        "--adversarial", "--no_pallas"])
    eval_segmentation.main()
    out = capsys.readouterr().out
    assert "mIoU" in out or "miou" in out
