"""Losses and adversarial objectives (SURVEY.md §2.5).

* Supervised cross-entropy on log-probabilities (the reference's
  ``NLLLoss`` over ``log_softmax`` outputs — ``BASELINE.json:7``).
* Orthogonality regularizer on T-Net transforms
  (``upstream:pointnet/model.py::feature_transform_regularizer``).
* Hung et al. 2018 adversarial objectives for semi-supervised
  segmentation: generator adversarial loss (eq. 3), discriminator
  real/fake loss (eq. 2), and the confidence-masked semi-supervised
  self-training loss (eq. 4-5).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def _pick_class(log_probs: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """``log_probs[..., labels]`` via a one-hot contraction.

    ``jnp.take_along_axis`` over the class dim lowers to a gather whose
    backward is a scatter-add. The one-hot multiply+reduce is a fused
    elementwise op instead, and is bit-exact (the zero terms add exactly
    nothing).
    """
    one_hot = jax.nn.one_hot(labels, log_probs.shape[-1],
                             dtype=log_probs.dtype)
    return jnp.sum(log_probs * one_hot, axis=-1)


def nll_loss(log_probs: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """Mean negative log-likelihood. ``log_probs [..., k]``, ``labels [...]``.

    Works for per-shape classification (``[B, k]``) and per-point
    segmentation (``[B, N, k]``) exactly like torch ``NLLLoss`` with mean
    reduction over all leading axes.
    """
    return -jnp.mean(_pick_class(log_probs, labels))


cross_entropy = nll_loss


def orthogonality_reg(trans: Optional[jnp.ndarray]) -> jnp.ndarray:
    """``mean_b || I - A_b A_b^T ||_F`` over the batch of k x k transforms.

    The reference's ``feature_transform_regularizer`` (weight 0.001 in the
    training loss, ``BASELINE.json:5`` / PointNet paper §C).
    """
    if trans is None:
        return jnp.asarray(0.0)
    k = trans.shape[-1]
    eye = jnp.eye(k, dtype=trans.dtype)
    gram = jnp.matmul(trans, jnp.swapaxes(trans, -1, -2),
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=trans.dtype)
    return jnp.mean(jnp.linalg.norm(eye - gram, axis=(-2, -1)))


def bce_with_logits(logits: jnp.ndarray, target: float | jnp.ndarray,
                    ) -> jnp.ndarray:
    """Mean binary cross-entropy on logits (torch ``BCEWithLogitsLoss``).

    Numerically stable form: ``max(z,0) - z*t + log(1+exp(-|z|))``.
    """
    z = logits
    t = jnp.broadcast_to(jnp.asarray(target, z.dtype), z.shape)
    loss = jnp.maximum(z, 0) - z * t + jnp.log1p(jnp.exp(-jnp.abs(z)))
    return jnp.mean(loss)


def adv_g_loss(d_logits: jnp.ndarray) -> jnp.ndarray:
    """Generator adversarial loss: fool D into REAL on predicted maps.

    ``BCE(D(softmax(G(x))), 1)`` — Hung et al. eq. 3.
    """
    return bce_with_logits(d_logits, 1.0)


def d_loss(d_logits_real: jnp.ndarray, d_logits_fake: jnp.ndarray,
           ) -> jnp.ndarray:
    """Discriminator loss: REAL on one-hot GT, FAKE on predictions.

    ``BCE(D(one_hot(y)), 1) + BCE(D(softmax(G(x))), 0)`` — Hung et al. eq. 2.
    The reference computes the two BCE terms as separate ``.backward()``
    contributions; summing them is identical.
    """
    return bce_with_logits(d_logits_real, 1.0) + bce_with_logits(d_logits_fake, 0.0)


def semi_loss(log_probs: jnp.ndarray, d_logits: jnp.ndarray,
              threshold: float) -> jnp.ndarray:
    """Confidence-masked self-training loss on unlabeled data.

    Hung et al. eq. 4-5: where ``sigmoid(D) > T_semi``, treat the
    generator's own argmax as ground truth and apply CE. The mask and the
    pseudo-labels are both treated as constants (no gradient), matching
    the reference's ``.detach()`` usage. Mean over masked points; 0 when
    the mask is empty.
    """
    pseudo = jax.lax.stop_gradient(jnp.argmax(log_probs, axis=-1))
    mask = jax.lax.stop_gradient(
        (jax.nn.sigmoid(d_logits[..., 0]) > threshold).astype(log_probs.dtype))
    picked = _pick_class(log_probs, pseudo)
    denom = jnp.maximum(jnp.sum(mask), 1.0)
    return -jnp.sum(picked * mask) / denom


def self_train_loss(log_probs: jnp.ndarray,
                    threshold: float) -> jnp.ndarray:
    """Confidence-masked self-training WITHOUT a discriminator.

    The D-free control for Hung et al.'s central claim (§5.2 of
    arXiv:1802.07934) that the discriminator's confidence map selects
    better pseudo-label regions than the generator's own confidence:
    mask = ``max_k softmax(G(x)) > threshold`` (instead of
    ``sigmoid(D) > T_semi``), pseudo-labels the argmax, mask and
    pseudo-labels detached, mean over masked points, 0 on an empty
    mask — the exact ``semi_loss`` recipe with the mask source swapped.
    """
    pseudo = jax.lax.stop_gradient(jnp.argmax(log_probs, axis=-1))
    conf = jnp.exp(jnp.max(log_probs, axis=-1))  # log_softmax -> max prob
    mask = jax.lax.stop_gradient(
        (conf > threshold).astype(log_probs.dtype))
    picked = _pick_class(log_probs, pseudo)
    denom = jnp.maximum(jnp.sum(mask), 1.0)
    return -jnp.sum(picked * mask) / denom
