#!/usr/bin/env python
"""CLI mirror of the reference's ``train_segmentation.py`` (config 3)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adversarial_learning_on_pointclouds.configs import (
    segment_config_from_args,
)
from adversarial_learning_on_pointclouds.train import runner


def main():
    cfg = segment_config_from_args()
    result = runner.run_segmentation(cfg)
    print(f"final best instance mIoU: {result['best_miou']:.4f}")
    for cat, miou in sorted(result["category_miou"].items()):
        print(f"  {cat:12s} {miou:.4f}")


if __name__ == "__main__":
    main()
