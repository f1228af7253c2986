#!/usr/bin/env python
"""CLI mirror of the reference's adversarial trainer (config 4):
semi-supervised segmentation with alternating G/D updates
(``--lambda_adv --lambda_semi --threshold --labeled_ratio --lr_D``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adversarial_learning_on_pointclouds.configs import (
    adversarial_config_from_args,
)
from adversarial_learning_on_pointclouds.train import runner


def main():
    cfg = adversarial_config_from_args()
    result = runner.run_adversarial(cfg)
    print(f"final best instance mIoU: {result['best_miou']:.4f}")


if __name__ == "__main__":
    main()
