"""Metric tests, including hand-computed mIoU vectors (SURVEY.md §7 #6)."""

import jax.numpy as jnp
import numpy as np
import pytest

from adversarial_learning_on_pointclouds.utils import metrics


def test_accuracy_and_class_accuracies():
    pred = np.array([0, 1, 1, 2])
    labels = np.array([0, 1, 0, 2])
    overall, avg_class = metrics.class_accuracies(pred, labels, 3)
    assert overall == pytest.approx(0.75)
    # class 0: 1/2, class 1: 1/1, class 2: 1/1 -> avg 5/6
    assert avg_class == pytest.approx((0.5 + 1.0 + 1.0) / 3)


def test_shape_iou_hand_computed():
    # Category 1 (Bag) has parts {4, 5}. One shape, 4 points.
    gt = np.array([[4, 4, 5, 5]])
    pred = np.array([[4, 5, 5, 5]])
    cats = np.array([1])
    # part 4: inter=1, union=2 -> 0.5 ; part 5: inter=2, union=3 -> 2/3
    expected = (0.5 + 2 / 3) / 2
    assert metrics.instance_miou(pred, gt, cats) == pytest.approx(expected)


def test_shape_iou_absent_part_counts_as_one():
    # Bag shape where only part 4 appears in both -> part 5 IoU = 1.
    gt = np.array([[4, 4, 4, 4]])
    pred = np.array([[4, 4, 4, 4]])
    assert metrics.instance_miou(pred, gt, np.array([1])) == pytest.approx(1.0)


def test_shape_iou_restricted_to_category_parts():
    # Predictions outside the category's range hurt only via the union of
    # in-range parts (they are never scored as their own class).
    gt = np.array([[4, 4, 5, 5]])
    pred = np.array([[12, 12, 12, 12]])  # Chair parts predicted on a Bag
    # part 4: inter 0, union 2 -> 0 ; part 5: inter 0, union 2 -> 0.
    assert metrics.instance_miou(pred, gt, np.array([1])) == pytest.approx(0.0)


def test_device_shape_iou_matches_numpy():
    rng = np.random.default_rng(0)
    cats = rng.integers(0, 16, size=8).astype(np.int32)
    from adversarial_learning_on_pointclouds.data.shapenet_part import (
        CATEGORY_PART_RANGES,
    )
    gt = np.empty((8, 64), np.int32)
    pred = np.empty((8, 64), np.int32)
    for i, c in enumerate(cats):
        start, count = CATEGORY_PART_RANGES[c]
        gt[i] = rng.integers(start, start + count, 64)
        pred[i] = rng.integers(start, start + count, 64)
    np_iou = metrics.shape_ious(pred, gt, cats)
    dev_iou = np.asarray(metrics.shape_ious_device(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(cats)))
    np.testing.assert_allclose(dev_iou, np_iou, rtol=1e-6)


def test_category_miou_table():
    gt = np.array([[4, 5], [12, 13]])
    pred = np.array([[4, 5], [12, 12]])
    cats = np.array([1, 4])  # Bag, Chair
    table = metrics.category_miou(pred, gt, cats)
    assert table["Bag"] == pytest.approx(1.0)
    assert "Chair" in table and table["Chair"] < 1.0


def test_evaluate_device_matches_host_loop():
    """evaluate_{classifier,segmenter}_device (single compiled scan over
    device-resident pools) == the host batch-loop protocol, including the
    padded+masked ragged final batch."""
    import jax

    from adversarial_learning_on_pointclouds import eval as eval_lib
    from adversarial_learning_on_pointclouds.data.shapenet_part import (
        CATEGORY_PART_RANGES,
    )
    from adversarial_learning_on_pointclouds.models import (
        init_classifier, init_segmenter,
    )

    rng = np.random.default_rng(3)
    n, npts, bs = 21, 64, 8  # 21 % 8 != 0 -> exercises pad+mask
    x = rng.standard_normal((n, npts, 3)).astype(np.float32)
    y_cls = rng.integers(0, 5, n).astype(np.int32)
    cats = rng.integers(0, 16, n).astype(np.int32)
    s_lab = np.empty((n, npts), np.int32)
    for i, c in enumerate(cats):
        start, count = CATEGORY_PART_RANGES[c]
        s_lab[i] = rng.integers(start, start + count, npts)

    cp, cs = init_classifier(jax.random.PRNGKey(0), 5)
    host = eval_lib.evaluate_classifier(cp, cs, x, y_cls, bs, 5)
    dev = eval_lib.evaluate_classifier_device(
        cp, cs, jnp.asarray(x), y_cls, bs, 5)
    assert host == dev

    sp, ss = init_segmenter(jax.random.PRNGKey(1), 50)
    h_sum, h_tab = eval_lib.evaluate_segmenter(sp, ss, x, s_lab, cats, bs)
    d_sum, d_tab = eval_lib.evaluate_segmenter_device(
        sp, ss, jnp.asarray(x), jnp.asarray(s_lab), jnp.asarray(cats),
        s_lab, cats, bs)
    for k in h_sum:
        assert h_sum[k] == pytest.approx(d_sum[k], rel=1e-6), k
    assert h_tab.keys() == d_tab.keys()
    for k in h_tab:
        assert h_tab[k] == pytest.approx(d_tab[k], rel=1e-6), k
