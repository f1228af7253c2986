"""Compute ops: plain jnp implementations + one hand-written GPU kernel.

Every op has a plain jnp implementation (the CPU-runnable path required
by config 1, ``BASELINE.json:7``). ``ops/dispatch.py`` decides where the
trunk-exit kernel (``ops/kernels/trunk_pool.py``) replaces it; the parity
tests in ``tests/test_trunk_pool.py`` pin the two together.
"""

from adversarial_learning_on_pointclouds.ops.dispatch import (  # noqa: F401
    linear_bn_act,
    linear_act,
    linear_bn_maxpool,
    max_points,
    pallas_enabled,
    use_pallas,
)
from adversarial_learning_on_pointclouds.models.core import (  # noqa: F401
    mixed_precision,
)
