#!/usr/bin/env python
"""CLI for config 5: FGSM adversarial-perturbation training (+ DP)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adversarial_learning_on_pointclouds.configs import (
    adv_perturb_config_from_args,
)
from adversarial_learning_on_pointclouds.train import runner


def main():
    cfg = adv_perturb_config_from_args()
    result = runner.run_adv_perturb(cfg)
    print(f"final best accuracy: {result['best_accuracy']:.4f}")


if __name__ == "__main__":
    main()
