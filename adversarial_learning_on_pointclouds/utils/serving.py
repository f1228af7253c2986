"""Ahead-of-time serving artifacts via ``jax.export`` (StableHLO).

The reference deploys by loading a ``.pth`` into a torch module and
calling it under ``eval()`` (``upstream:eval_*.py`` / ``show_*.py`` —
SURVEY.md §3.5); the serving analogue here is an EXPORTED program:
``jax.export`` lowers the eval-mode forward to StableHLO with the
trained parameters embedded as constants and serializes the whole thing
to one self-contained byte artifact. Any later process deserializes and
calls it — no model code, checkpoint tree, or config on the serving
side, and the artifact recompiles onto whatever hardware it lands on.

Two deliberate choices:

- Exports ride the plain XLA path (``dispatch.use_pallas(False)``): it
  lowers to pure StableHLO that retargets any listed platform at load
  time, where a kernel's custom call would pin the artifact to one
  backend.
- The batch dimension is SYMBOLIC by default (``"b"``): one artifact
  serves every batch size. The point count stays static — the models
  pool over it, and serving-side resampling to the training N is the
  documented contract (the reference evals at fixed ``--num_points``
  too).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import export as jexport

from adversarial_learning_on_pointclouds.ops import dispatch

DEFAULT_PLATFORMS: Tuple[str, ...] = ("cpu", "cuda")


def _export_pointcloud_fn(fn, num_points: int,
                          batch: Optional[int],
                          platforms: Sequence[str],
                          bf16: bool = False,
                          ) -> jexport.Exported:
    """Export ``fn(x: [b, num_points, 3]) -> outputs`` with a symbolic
    batch dim (``batch=None``) or a pinned one.

    The traced precision is EXPLICIT, not ambient: fp32 HIGHEST by
    default (parity artifacts), bf16 mixed under ``bf16=True`` (~1e-2
    relative deviation). Without this pin, an export
    from inside a training process's ``mixed_precision`` scope would
    silently bake bf16 matmuls into the artifact."""
    from adversarial_learning_on_pointclouds.models.core import (
        mixed_precision,
    )

    platforms = tuple(platforms)
    if batch is None:
        (b,) = jexport.symbolic_shape("b")
    else:
        b = batch
    spec = jax.ShapeDtypeStruct((b, num_points, 3), jnp.float32)

    def wrapped(x):
        # Platform-portable artifact: force the plain path regardless of
        # the exporting process's dispatch state.
        with dispatch.use_pallas(False), mixed_precision(enabled=bf16):
            return fn(x)

    return jexport.export(jax.jit(wrapped), platforms=platforms)(spec)


def export_classifier(params, bn_state, num_points: int = 1024,
                      batch: Optional[int] = None,
                      platforms: Sequence[str] = DEFAULT_PLATFORMS,
                      bf16: bool = False) -> jexport.Exported:
    """Eval-mode classifier forward ``x [b, N, 3] -> log_probs [b, k]``
    with ``params``/``bn_state`` (running statistics) baked in as
    constants."""
    from adversarial_learning_on_pointclouds.models.classifier import (
        apply_classifier,
    )

    def fwd(x):
        logp, _, _, _ = apply_classifier(params, bn_state, x, train=False)
        return logp

    return _export_pointcloud_fn(fwd, num_points, batch, platforms, bf16)


def export_segmenter(params, bn_state, num_points: int = 2500,
                     batch: Optional[int] = None,
                     platforms: Sequence[str] = DEFAULT_PLATFORMS,
                     bf16: bool = False) -> jexport.Exported:
    """Eval-mode segmenter forward ``x [b, N, 3] -> log_probs [b, N, k]``
    (the adversarial trainer's G serves through this too — its generator
    IS the segmenter, ``state.g_params``/``state.g_bn_state``)."""
    from adversarial_learning_on_pointclouds.models.segmenter import (
        apply_segmenter,
    )

    def fwd(x):
        logp, _, _, _ = apply_segmenter(params, bn_state, x, train=False)
        return logp

    return _export_pointcloud_fn(fwd, num_points, batch, platforms, bf16)


def save_exported(exp: jexport.Exported, path: str) -> None:
    """Serialize an ``Exported`` to one self-contained artifact file."""
    with open(path, "wb") as f:
        f.write(exp.serialize())


def load_exported(path: str) -> jexport.Exported:
    """Deserialize a serving artifact; run it with ``loaded.call(x)``."""
    with open(path, "rb") as f:
        return jexport.deserialize(bytearray(f.read()))
