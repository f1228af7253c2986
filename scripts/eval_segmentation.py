#!/usr/bin/env python
"""CLI mirror of the reference's segmentation eval (``show_seg``-style):
loads a checkpoint, reports instance mIoU + per-category table, and can
export colored ``.ply`` point clouds (the headless replacement for
the lineage's OpenGL viewer; SURVEY.md §2.10 "Visualization")."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, required=True,
                   help="checkpoint dir (as written by training) or a "
                        "reference-format .pth state_dict")
    p.add_argument("--dataset", type=str, default="")
    p.add_argument("--split", type=str, default="test",
                   choices=("test", "val", "train"),
                   help="which split to evaluate (the split's files must "
                        "exist in the dataset layout)")
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--class_choice", type=str, default=None)
    p.add_argument("--no_pallas", action="store_true")
    p.add_argument("--export_ply", type=str, default=None,
                   help="write the first batch's predictions here as .ply")
    p.add_argument("--adversarial", action="store_true",
                   help="checkpoint is a GAN state (config 4)")
    a = p.parse_args()

    from adversarial_learning_on_pointclouds import eval as eval_lib
    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig, SegmentConfig,
    )
    from adversarial_learning_on_pointclouds.ops import use_pallas
    from adversarial_learning_on_pointclouds.train import (
        adversarial, runner, segment,
    )
    from adversarial_learning_on_pointclouds.utils import checkpoint

    if a.adversarial:
        cfg = AdversarialConfig(batch_size=a.batchSize,
                                num_points=a.num_points, dataset=a.dataset,
                                class_choice=a.class_choice)
        # Generator subtree only: restores --d_geometry checkpoints
        # (wider D input) although eval never touches D (ADVICE r3).
        # A reference .pth loads its G weights the same way.
        tmpl = adversarial.create_state(cfg, steps_per_epoch=1)
        if a.model.endswith(".pth"):
            params, bn_state = checkpoint.load_pth_generator(a.model, tmpl)
        else:
            sub = checkpoint.restore_fields(
                a.model, tmpl, ("g_params", "g_bn_state"))
            params, bn_state = sub["g_params"], sub["g_bn_state"]
    else:
        cfg = SegmentConfig(batch_size=a.batchSize, num_points=a.num_points,
                            dataset=a.dataset, class_choice=a.class_choice)
        state = segment.create_state(cfg, steps_per_epoch=1)
        # load_params_only: eval needs params+BN only, and it accepts both
        # checkpoint dirs and reference .pth files.
        state = checkpoint.load_params_only(a.model, state)
        params, bn_state = state.params, state.bn_state

    _, (x_te, s_te, c_te) = runner._shapenet_arrays(cfg, eval_split=a.split)
    with use_pallas(not a.no_pallas):
        ev, table = eval_lib.evaluate_segmenter(
            params, bn_state, x_te, s_te, c_te, cfg.batch_size)
    print(f"instance mIoU: {ev['instance_miou']:.4f}")
    print(f"point accuracy: {ev['point_accuracy']:.4f}")
    for cat, miou in sorted(table.items()):
        print(f"  {cat:12s} {miou:.4f}")

    if a.export_ply:
        import numpy as np

        from adversarial_learning_on_pointclouds.train import segment as seg
        from adversarial_learning_on_pointclouds.utils.ply import (
            write_ply_with_labels,
        )
        out = seg.eval_step(params, bn_state, x_te[:4], s_te[:4], c_te[:4])
        pred = np.asarray(out["pred"])
        os.makedirs(a.export_ply, exist_ok=True)
        for i in range(pred.shape[0]):
            path = os.path.join(a.export_ply, f"shape{i}.ply")
            write_ply_with_labels(path, x_te[i], pred[i])
            print(f"wrote {path}")


if __name__ == "__main__":
    main()
