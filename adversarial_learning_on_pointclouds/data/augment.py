"""On-device point-cloud augmentation chain.

JAX rebuild of the reference's numpy ``provider.py``-style free
functions (``upstream:provider.py::rotate_point_cloud`` /
``jitter_point_cloud`` / ``random_point_dropout``; SURVEY.md §2.2). All
functions are pure, batched over ``[B, N, 3]``, keyed by ``jax.random``,
and shape-static — so the full chain jits into the train step and runs on
device (``BASELINE.json:5`` "fused on-device preprocessing stage"), where
XLA fuses the elementwise chain into one pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def normalize_unit_sphere(points: jnp.ndarray) -> jnp.ndarray:
    """Center each cloud at its centroid and scale into the unit sphere.

    Reference: inline in ``upstream:dataset.py::__getitem__`` (SURVEY.md
    §2.1): subtract centroid, divide by max point L2 norm.
    """
    centroid = jnp.mean(points, axis=-2, keepdims=True)
    centered = points - centroid
    scale = jnp.max(jnp.linalg.norm(centered, axis=-1, keepdims=True),
                    axis=-2, keepdims=True)
    return centered / jnp.maximum(scale, 1e-12)


def resample_fixed_n(rng: jax.Array, points: jnp.ndarray, num_points: int,
                     labels: jnp.ndarray | None = None):
    """Fixed-N resample: choose ``num_points`` indices with replacement.

    Reference: ``np.random.choice(n, npoints, replace=True)`` in
    ``__getitem__`` (SURVEY.md §2.1 "Fixed-N resample"). Batched gather on
    device; optionally gathers per-point labels with the same indices
    (segmentation).
    """
    b, n = points.shape[0], points.shape[1]
    idx = jax.random.randint(rng, (b, num_points), 0, n)
    gathered = jnp.take_along_axis(points, idx[..., None], axis=1)
    if labels is None:
        return gathered
    glabels = jnp.take_along_axis(labels, idx, axis=1)
    return gathered, glabels


def random_rotate(rng: jax.Array, points: jnp.ndarray) -> jnp.ndarray:
    """Uniform random rotation about the up (Y) axis, one angle per cloud.

    Reference: ``upstream:provider.py::rotate_point_cloud``. The rotation
    is a per-cloud 3x3 matmul — batched ``[B, N, 3] @ [B, 3, 3]``.
    """
    b = points.shape[0]
    angle = jax.random.uniform(rng, (b,), points.dtype, 0.0, 2.0 * jnp.pi)
    c, s = jnp.cos(angle), jnp.sin(angle)
    zeros, ones = jnp.zeros_like(c), jnp.ones_like(c)
    # Row-major rotation about Y: provider.py's [[c,0,s],[0,1,0],[-s,0,c]].
    rot = jnp.stack([
        jnp.stack([c, zeros, s], axis=-1),
        jnp.stack([zeros, ones, zeros], axis=-1),
        jnp.stack([-s, zeros, c], axis=-1),
    ], axis=-2)
    return jnp.matmul(points, rot, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=points.dtype)


def jitter(rng: jax.Array, points: jnp.ndarray, sigma: float = 0.01,
           clip: float = 0.05) -> jnp.ndarray:
    """Clipped Gaussian per-point jitter.

    Reference: ``upstream:provider.py::jitter_point_cloud`` with the
    PointNet paper defaults sigma=0.01, clip=0.05.
    """
    noise = sigma * jax.random.normal(rng, points.shape, points.dtype)
    return points + jnp.clip(noise, -clip, clip)


def point_dropout(rng: jax.Array, points: jnp.ndarray,
                  max_dropout_ratio: float = 0.875) -> jnp.ndarray:
    """Random point dropout, replacing dropped points with the first point.

    Reference: ``upstream:provider.py::random_point_dropout``: draw a
    dropout ratio r ~ U(0, max) per cloud, drop each point with
    probability r, overwrite dropped points with point 0 — the cloud stays
    rectangular, which is already the accelerator-friendly formulation (mask +
    where, no ragged shapes).
    """
    b, n, _ = points.shape
    k_ratio, k_mask = jax.random.split(rng)
    ratio = jax.random.uniform(k_ratio, (b, 1), points.dtype,
                               0.0, max_dropout_ratio)
    u = jax.random.uniform(k_mask, (b, n), points.dtype)
    drop = (u <= ratio)[..., None]
    first = points[:, :1, :]
    return jnp.where(drop, first, points)


def normalize_unit_sphere_np(points: np.ndarray) -> np.ndarray:
    """Host-side (numpy) unit-sphere normalize, for deterministic eval-set
    preparation — same math as ``normalize_unit_sphere``."""
    points = np.asarray(points, np.float32)
    centered = points - points.mean(axis=-2, keepdims=True)
    scale = np.max(np.linalg.norm(centered, axis=-1, keepdims=True),
                   axis=-2, keepdims=True)
    return centered / np.maximum(scale, 1e-12)


def augment_batch(rng: jax.Array, points: jnp.ndarray,
                  labels: jnp.ndarray | None = None, *,
                  num_points: int | None = None,
                  normalize: bool = False, resample: bool = False,
                  rotate: bool = True, do_jitter: bool = True,
                  dropout: bool = False):
    """The fused chain: normalize -> resample -> rotate -> jitter -> dropout.

    Order follows the reference (SURVEY.md §2.2 "Fused chain", [A] per
    ``BASELINE.json:5``): the reference's ``__getitem__`` normalizes over
    the FULL point set, then draws a fresh fixed-N ``np.random.choice``
    subsample every access, then ``provider.py`` augments. ``labels``
    (per-point, segmentation) ride the same resample gather. All of this
    inlines into the jitted train step, so XLA fuses it with the
    device-side batch prep — zero extra HBM round-trips.

    Returns ``points`` or ``(points, labels)`` when labels are given.
    """
    k_res, k_rot, k_jit, k_drop = jax.random.split(rng, 4)
    if normalize:
        points = normalize_unit_sphere(points)
    if resample and num_points is not None:
        if labels is None:
            points = resample_fixed_n(k_res, points, num_points)
        else:
            points, labels = resample_fixed_n(k_res, points, num_points,
                                              labels)
    if rotate:
        points = random_rotate(k_rot, points)
    if do_jitter:
        points = jitter(k_jit, points)
    if dropout:
        points = point_dropout(k_drop, points)
    return points if labels is None else (points, labels)


def chain_from_cfg(rng: jax.Array, cfg, points: jnp.ndarray,
                   labels: jnp.ndarray | None = None):
    """The config-driven preprocessing chain every train step applies.

    The reference splits this between ``__getitem__`` (normalize +
    resample, always on) and the train loop's augmentation flag
    (rotate/jitter) plus ``provider.py`` dropout; here one fused on-device
    stage, gated by ``cfg.normalize`` / ``cfg.resample`` / ``cfg.augment``
    / ``cfg.point_dropout``.
    """
    resample = cfg.resample and points.shape[1] != cfg.num_points
    return augment_batch(
        rng, points, labels, num_points=cfg.num_points,
        normalize=cfg.normalize, resample=resample,
        rotate=cfg.augment, do_jitter=cfg.augment,
        dropout=cfg.point_dropout)
