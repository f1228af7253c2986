"""Point-wise FCN discriminator for adversarial segmentation.

Reference: ``upstream:model/discriminator.py`` — Hung et al. 2018
``FCDiscriminator`` adapted to point clouds (SURVEY.md §2.4): input is a
per-point class-probability map (``softmax(G(x))`` or one-hot ground
truth, ``[B, N, num_parts]``); a pointwise conv stack
k->64->128->256->512->1 with LeakyReLU(0.2) between layers, **no
BatchNorm** (GAN discriminator convention), outputs per-point real/fake
*logits* ``[B, N, 1]`` (loss uses BCE-with-logits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds.models import core
from adversarial_learning_on_pointclouds.ops import dispatch as ops

_WIDTHS = (64, 128, 256, 512)


def init_discriminator(key: jax.Array, num_parts: int = 50, ndf: int = 64,
                       dtype=jnp.float32) -> core.Params:
    del ndf  # widths fixed to the reference's 64-doubling stack
    keys = jax.random.split(key, 5)
    params = {}
    c_in = num_parts
    for i, c_out in enumerate(_WIDTHS, start=1):
        params[f"conv{i}"] = core.torch_linear_init(keys[i - 1], c_in, c_out, dtype)
        c_in = c_out
    params["conv5"] = core.torch_linear_init(keys[4], c_in, 1, dtype)
    return params


def apply_discriminator(params: core.Params, prob_map: jnp.ndarray,
                        ) -> jnp.ndarray:
    """``prob_map: [B, N, k]`` -> per-point real/fake logits ``[B, N, 1]``."""
    h = prob_map
    for i in range(1, 5):
        h = ops.linear_act(params[f"conv{i}"], h, act="leaky_relu")
    return ops.linear_act(params["conv5"], h, act=None)
