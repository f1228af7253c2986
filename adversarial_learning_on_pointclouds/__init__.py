"""Adversarial point-cloud learning framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``YiruS/Adversarial_Learning_on_PointClouds`` (PyTorch reference; see
``SURVEY.md``):

* PointNet backbone (shared-MLP stacks, STN3d/STNkd T-Nets, symmetric
  max-pool) for ModelNet40 classification and ShapeNet-part segmentation.
* Adversarial semi-supervised segmentation (Hung et al. 2018 style):
  PointNet generator + point-wise FCN discriminator, alternating G/D updates
  compiled into a single jitted train step.
* FGSM-style adversarial point-perturbation training.
* Fused on-device augmentation chain (normalize, rotate, jitter, dropout,
  fixed-N resample).
* Data-parallel training over a ``jax.sharding.Mesh`` with gradient
  all-reduce.

The short import alias ``pointtpu`` re-exports this package.
"""

# Keep in sync with pyproject.toml [project] version.
__version__ = "0.4.0"

from adversarial_learning_on_pointclouds import configs  # noqa: F401
