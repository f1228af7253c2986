"""docs/API.md rot guard: the public names the API reference documents
must exist where it says they do, and every script it lists must exist.

The check is curated (one representative per documented bullet), not a
full parse — the point is that a rename/removal in the package breaks
this test until the doc is updated."""

import importlib
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "adversarial_learning_on_pointclouds"

# (module, attribute) pairs the doc names, one-plus per section.
DOCUMENTED = [
    (f"{PKG}.models", "init_tnet"),
    (f"{PKG}.models", "apply_tnet_pair"),
    (f"{PKG}.models", "apply_encoder_parts"),
    (f"{PKG}.models", "apply_classifier"),
    (f"{PKG}.models", "apply_segmenter_pair"),
    (f"{PKG}.models", "apply_discriminator"),
    (f"{PKG}.models.core", "batch_norm_grouped"),
    (f"{PKG}.models.core", "mixed_precision"),
    (f"{PKG}.losses", "nll_loss"),
    (f"{PKG}.losses", "orthogonality_reg"),
    (f"{PKG}.losses", "semi_loss"),
    (f"{PKG}.losses", "self_train_loss"),
    (f"{PKG}.attacks", "fgsm_points"),
    (f"{PKG}.attacks", "iterated_fgsm_points"),
    (f"{PKG}.configs", "ClassifyConfig"),
    (f"{PKG}.configs", "adversarial_config_from_args"),
    (f"{PKG}.train.classify", "train_step"),
    (f"{PKG}.train.adversarial", "epoch_program"),
    (f"{PKG}.train.adversarial", "train_step_gather"),
    (f"{PKG}.train.state", "GANTrainState"),
    (f"{PKG}.train.state", "epoch_program_fns"),
    (f"{PKG}.train.runner", "run_adversarial"),
    (f"{PKG}.eval", "evaluate_classifier_device"),
    (f"{PKG}.eval", "evaluate_segmenter"),
    (f"{PKG}.utils.metrics", "instance_miou"),
    (f"{PKG}.utils.metrics", "shape_ious_device"),
    (f"{PKG}.data", "make_synthetic_shapenet"),
    (f"{PKG}.data", "ShapeNetPart"),
    (f"{PKG}.data.loader", "host_index_iterator"),
    (f"{PKG}.data.loader", "device_batches"),
    (f"{PKG}.data.augment", "chain_from_cfg"),
    (f"{PKG}.data.native_loader", "native_available"),
    (f"{PKG}.parallel", "make_mesh"),
    (f"{PKG}.parallel", "make_multihost_mesh"),
    (f"{PKG}.parallel", "point_sharded_eval"),
    (f"{PKG}.parallel", "point_sharded_train_step"),
    (f"{PKG}.utils.checkpoint", "AsyncSaver"),
    (f"{PKG}.utils.checkpoint", "load_pth_warm_start"),
    (f"{PKG}.utils.checkpoint", "restore_fields"),
    (f"{PKG}.utils.torch_import", "load_pth"),
    (f"{PKG}.utils.torch_export", "save_pth"),
    (f"{PKG}.utils.serving", "export_segmenter"),
    (f"{PKG}.utils.serving", "load_exported"),
    (f"{PKG}.utils.logging", "MetricLogger"),
    (f"{PKG}.utils.profiling", "maybe_trace"),
    (f"{PKG}.utils.ply", "write_ply_with_labels"),
    (f"{PKG}.ops.dispatch", "use_pallas"),
    (f"{PKG}.ops.dispatch", "linear_bn_maxpool"),
    (f"{PKG}.ops.kernels.trunk_pool", "bn_maxpool_train"),
    (f"{PKG}.data", "synthetic_shapenet"),
    (f"{PKG}.utils.compile_cache", "enable_persistent_cache"),
    (f"{PKG}.utils.device", "require_gpu"),
]


def test_documented_api_exists():
    missing = []
    for mod, attr in DOCUMENTED:
        try:
            m = importlib.import_module(mod)
        except ImportError as e:  # pragma: no cover - rot signal
            missing.append((mod, attr, f"import failed: {e}"))
            continue
        if not hasattr(m, attr):
            missing.append((mod, attr, "attribute missing"))
    assert not missing, missing


def test_documented_scripts_exist():
    doc = open(os.path.join(REPO, "docs", "API.md")).read()
    # Every `*.py` the doc names under scripts/ must exist (names are
    # unique enough that a bare filename identifies the script).
    named = set(re.findall(r"`([\w/]+\.py)`", doc))
    missing = []
    for name in named:
        rel = name if "/" in name else os.path.join("scripts", name)
        if not os.path.exists(os.path.join(REPO, rel)):
            missing.append(name)
    assert not missing, missing
    assert len(named) >= 15, sorted(named)  # the doc really lists them
