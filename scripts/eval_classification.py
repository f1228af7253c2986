#!/usr/bin/env python
"""CLI mirror of the reference's classification eval (``show_cls``-style):
loads a checkpoint, reports overall + avg per-class accuracy."""

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
                   help="which split to evaluate (the split's "
                        "{split}_files.txt must exist)")
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--feature_transform", action="store_true")
    p.add_argument("--no_pallas", action="store_true")
    a = p.parse_args()

    from adversarial_learning_on_pointclouds import eval as eval_lib
    from adversarial_learning_on_pointclouds.configs import ClassifyConfig
    from adversarial_learning_on_pointclouds.ops import use_pallas
    from adversarial_learning_on_pointclouds.train import classify, runner
    from adversarial_learning_on_pointclouds.utils import checkpoint

    cfg = ClassifyConfig(batch_size=a.batchSize, num_points=a.num_points,
                         dataset=a.dataset,
                         feature_transform=a.feature_transform)
    _, _, x_te, y_te = runner._modelnet_arrays(cfg, eval_split=a.split)
    state = classify.create_state(cfg, steps_per_epoch=1)
    # load_params_only: eval needs params+BN only, and it accepts both
    # checkpoint dirs and reference .pth files.
    state = checkpoint.load_params_only(a.model, state)
    with use_pallas(not a.no_pallas):
        ev = eval_lib.evaluate_classifier(
            state.params, state.bn_state, x_te, y_te, cfg.batch_size,
            cfg.num_classes)
    print(f"accuracy: {ev['accuracy']:.4f}")
    print(f"avg class accuracy: {ev['avg_class_accuracy']:.4f}")


if __name__ == "__main__":
    main()
