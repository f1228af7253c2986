"""Training loops: the five baseline configs (SURVEY.md §2.6).

Each trainer builds ONE jitted ``train_step`` that contains everything the
reference does per batch — on-device augmentation, forward, loss(es),
backward, optimizer update(s) — so a step is a single XLA program and DP
gradient allreduce rides ICI inside it (``BASELINE.json:5``).
"""

from adversarial_learning_on_pointclouds.train import (  # noqa: F401
    adversarial, adv_perturb, classify, segment, state,
)
