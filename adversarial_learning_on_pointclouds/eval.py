"""Evaluation loops (SURVEY.md §2.6 "Eval scripts", §3.5).

Classification: overall + average per-class accuracy (the reference's
``eval`` pass / ``show_cls``-style scripts). Segmentation: per-shape
category-restricted IoU averaged over shapes (instance mIoU) + the
per-category table. Batched inference runs the same model code as
training, so it takes the same kernel route (``ops/dispatch.py``;
``BASELINE.json:5`` "Inference runs the same fused encoder kernels").
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from adversarial_learning_on_pointclouds.data.loader import (
    batch_iterator, num_batches,
)
from adversarial_learning_on_pointclouds.train import classify, segment
from adversarial_learning_on_pointclouds.utils import metrics
from adversarial_learning_on_pointclouds.utils.logging import (
    start_host_fetch,
)


def _eval_indices(n: int, batch_size: int):
    """Sequential batch index plan for a device-resident test pool:
    ``[S, B]`` int32 rows covering 0..n-1 in order (final batch padded by
    wrapping) + the flat validity mask selecting the first n outputs —
    the device twin of ``batch_iterator(shuffle=False, drop_last=False)``'s
    pad+mask protocol."""
    s = -(-n // batch_size)
    flat = np.arange(s * batch_size) % n
    mask = np.arange(s * batch_size) < n
    return flat.reshape(s, batch_size).astype(np.int32), mask


def summarize_classifier_preds(preds, labels: np.ndarray, mask: np.ndarray,
                               num_classes: int = 40) -> Dict[str, float]:
    """Host-side reduction of a ``classify.eval_scan``-shaped ``[S, B]``
    prediction array into the accuracy summary. Shared by
    ``evaluate_classifier_device`` and the ``--fused_epoch`` paths."""
    pred = np.asarray(preds).reshape(-1)[mask]
    overall, avg_class = metrics.class_accuracies(pred, labels, num_classes)
    return {"accuracy": overall, "avg_class_accuracy": avg_class,
            "num_examples": float(len(labels))}


def evaluate_classifier_device(params, bn_state, pool_x, labels: np.ndarray,
                               batch_size: int = 32, num_classes: int = 40,
                               ) -> Dict[str, float]:
    """``evaluate_classifier`` against a DEVICE-RESIDENT test pool: the
    whole test pass runs as one compiled scan (``classify.eval_scan``) —
    one dispatch + one [S*B] readback per eval. Same protocol/results as
    the host-loop path (tests pin equality)."""
    idx, mask = _eval_indices(len(labels), batch_size)
    preds = classify.eval_scan(params, bn_state, pool_x, idx)
    return summarize_classifier_preds(preds, labels, mask, num_classes)


def summarize_segmenter_outs(outs, part_labels: np.ndarray,
                             categories: np.ndarray, mask: np.ndarray,
                             ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Host-side reduction of a ``segment.eval_scan``-shaped output
    (``{"ious": [S,B], "correct": [S,B]}``) into the eval summary + the
    per-category mIoU table. Shared by ``evaluate_segmenter_device`` and
    the fused epoch program path (``--fused_epoch``)."""
    n = len(part_labels)
    npts = part_labels.shape[-1]
    iou_all = np.asarray(outs["ious"]).reshape(-1)[mask]
    correct = np.asarray(outs["correct"]).reshape(-1)[mask]
    summary = {
        "instance_miou": float(iou_all.mean()),
        "point_accuracy": float(correct.sum() / (n * npts)),
        "num_shapes": float(n),
    }
    table = metrics.category_miou_from_ious(iou_all, categories)
    return summary, table


def evaluate_segmenter_device(params, bn_state, pool_x, pool_s, pool_c,
                              part_labels: np.ndarray,
                              categories: np.ndarray, batch_size: int = 32,
                              ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``evaluate_segmenter`` against device-resident test pools via one
    compiled scan (``segment.eval_scan``). Only per-shape reductions
    (IoU + correct-point counts) cross the device->host link; the
    per-category table derives from the IoU vector + the host
    ``categories`` copy (``part_labels`` supplies point count/shape n)."""
    idx, mask = _eval_indices(len(part_labels), batch_size)
    outs = segment.eval_scan(params, bn_state, pool_x, pool_s, pool_c, idx)
    return summarize_segmenter_outs(outs, part_labels, categories, mask)


def _fetch_async(out) -> None:
    """Start non-blocking device->host copies of an eval step's outputs
    (shared helper — see ``utils.logging.start_host_fetch``)."""
    start_host_fetch(out)


def _host_masks(n: int, batch_size: int):
    """Host-side twin of the validity masks ``host_index_iterator``
    appends at ``drop_last=False``: positional (all-True except the final
    ragged batch, whose pad rows are False), so they can be recomputed
    from ``n`` alone — reading ``batch[-1]`` back would pay a per-batch
    device->host round trip inside the enqueue loop for a mask the host
    itself just produced."""
    for start in range(0, n, batch_size):
        yield np.arange(batch_size) < (n - start)


def _eval_batches(arrays, batch_size: int):
    """Eval-order device batches paired with HOST-side validity masks.

    Yields ``(data_batch, mask)`` where ``data_batch`` excludes the
    iterator's own mask element. The host twin (``_host_masks``) is only
    valid because this helper FIXES the iteration order — shuffle=False
    keeps batches in row order and ``host_index_iterator`` pads only the
    final ragged batch; any change to eval iteration order must go
    through here (ADVICE r3: the coupling lives in one place, not at
    every zip site). Set ``POINTTPU_CHECK_EVAL_MASKS=1`` (exactly) to
    verify the
    recomputed masks against the iterator-provided ones (costs one
    device->host readback per batch; exercised by the test suite)."""
    n = len(arrays[0])
    check = os.environ.get("POINTTPU_CHECK_EVAL_MASKS") == "1"
    count = 0
    for batch, mask in zip(
            batch_iterator(arrays, batch_size, shuffle=False,
                           drop_last=False),
            _host_masks(n, batch_size)):
        if check:
            np.testing.assert_array_equal(np.asarray(batch[-1]), mask)
        count += 1
        yield batch[:-1], mask
    assert count == num_batches(n, batch_size, drop_last=False)


def evaluate_classifier(params, bn_state, points: np.ndarray,
                        labels: np.ndarray, batch_size: int = 32,
                        num_classes: int = 40) -> Dict[str, float]:
    """Returns overall accuracy and average per-class accuracy."""
    # Device outputs are materialized AFTER the loop: every batch's
    # forward is enqueued back-to-back and the host<->device round trips
    # overlap the compute instead of serializing it.
    pending = []
    for batch, mask in _eval_batches((points, labels), batch_size):
        pts, lab = batch[0], batch[1]
        out = classify.eval_step(params, bn_state, pts, lab)
        _fetch_async(out)
        pending.append((out["pred"], lab, mask))
    preds, gts = [], []
    for p_dev, lab, mask in pending:
        p, l_ = np.asarray(p_dev), np.asarray(lab)
        if mask is not None:
            p, l_ = p[mask], l_[mask]
        preds.append(p)
        gts.append(l_)
    pred = np.concatenate(preds)
    gt = np.concatenate(gts)
    overall, avg_class = metrics.class_accuracies(pred, gt, num_classes)
    return {"accuracy": overall, "avg_class_accuracy": avg_class,
            "num_examples": float(len(gt))}


def evaluate_segmenter(params, bn_state, points: np.ndarray,
                       part_labels: np.ndarray, categories: np.ndarray,
                       batch_size: int = 32,
                       ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Returns (summary, per-category mIoU table)."""
    # Same deferred-readback pipelining as evaluate_classifier: enqueue
    # every batch's forward first, materialize afterwards.
    pending = []
    for batch, mask in _eval_batches((points, part_labels, categories),
                                     batch_size):
        pts, lab, cat = batch[0], batch[1], batch[2]
        out = segment.eval_step(params, bn_state, pts, lab, cat)
        _fetch_async(out)
        pending.append((out, lab, cat, mask))
    ious, accs, preds, gts, cats = [], [], [], [], []
    for out, lab, cat, mask in pending:
        iou = np.asarray(out["ious"])
        pred = np.asarray(out["pred"])
        labn, catn = np.asarray(lab), np.asarray(cat)
        if mask is not None:
            iou, pred, labn, catn = iou[mask], pred[mask], labn[mask], catn[mask]
        ious.append(iou)
        accs.append((pred == labn).mean(axis=1))
        preds.append(pred)
        gts.append(labn)
        cats.append(catn)
    iou_all = np.concatenate(ious)
    summary = {
        "instance_miou": float(iou_all.mean()),
        "point_accuracy": float(np.concatenate(accs).mean()),
        "num_shapes": float(len(iou_all)),
    }
    table = metrics.category_miou(np.concatenate(preds), np.concatenate(gts),
                                  np.concatenate(cats))
    return summary, table
