#!/usr/bin/env python
"""Adversarial-robustness evaluation: classifier accuracy under FGSM/PGD
point-perturbation attacks across epsilons (the eval counterpart of the
reference's attack training, ``BASELINE.json:11``)."""

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
    p.add_argument("--epsilons", type=float, nargs="+",
                   default=[0.0, 0.01, 0.025, 0.05, 0.1])
    p.add_argument("--pgd_steps", type=int, default=0,
                   help="0 = single-step FGSM; >0 = PGD with that many steps")
    a = p.parse_args()

    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from adversarial_learning_on_pointclouds import attacks, losses
    from adversarial_learning_on_pointclouds.configs import ClassifyConfig
    from adversarial_learning_on_pointclouds.data.loader import (
        batch_iterator,
    )
    from adversarial_learning_on_pointclouds.models import apply_classifier
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
    params, bn_state = state.params, state.bn_state

    @functools.partial(jax.jit, static_argnames=("eps", "steps"))
    def attacked_correct(pts, labels, eps: float, steps: int):
        def loss(x):
            logp, _, _, _ = apply_classifier(params, bn_state, x, train=False)
            return losses.nll_loss(logp, labels)

        if eps > 0 and steps > 0:
            x_adv = attacks.iterated_fgsm_points(loss, pts, eps, steps)
        elif eps > 0:
            x_adv = attacks.fgsm_points(loss, pts, eps)
        else:
            x_adv = pts
        logp, _, _, _ = apply_classifier(params, bn_state, x_adv, train=False)
        return jnp.argmax(logp, -1) == labels  # per-example, for masking

    for eps in a.epsilons:
        correct = total = 0
        # drop_last=False + validity mask: cover the whole test set (the
        # final ragged batch is padded; pad rows are masked out), matching
        # eval.evaluate_classifier's protocol.
        for pts, lab, mask in batch_iterator((x_te, y_te), cfg.batch_size,
                                             shuffle=False, drop_last=False):
            ok = np.asarray(attacked_correct(pts, lab, float(eps),
                                             int(a.pgd_steps)))
            m = np.asarray(mask)
            correct += int(ok[m].sum())
            total += int(m.sum())
        kind = f"PGD-{a.pgd_steps}" if a.pgd_steps else "FGSM"
        print(f"eps={eps:<6g} {kind} accuracy: {correct / max(total, 1):.4f}")


if __name__ == "__main__":
    main()
