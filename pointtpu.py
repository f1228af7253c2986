"""Short alias: ``import pointtpu`` == the full framework package."""

import sys

import adversarial_learning_on_pointclouds as _pkg

sys.modules[__name__] = _pkg
