#!/usr/bin/env python
"""CLI mirror of the reference's ``train_classification.py`` (configs 1-2).

Same public flag surface (``--batchSize --num_points --nepoch --outf
--model --dataset --feature_transform --manualSeed``; SURVEY.md §2.10) on
the JAX trainer. With no ``--dataset``, trains on synthetic
fixtures with the real ModelNet40 HDF5 schema.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adversarial_learning_on_pointclouds.configs import (
    classify_config_from_args,
)
from adversarial_learning_on_pointclouds.train import runner


def main():
    cfg = classify_config_from_args()
    result = runner.run_classification(cfg)
    print(f"final best accuracy: {result['best_accuracy']:.4f}")


if __name__ == "__main__":
    main()
