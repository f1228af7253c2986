"""The one place that chooses between the plain jnp/XLA ops and the
hand-written kernels.

The model layer only calls the functions here. The choice is made at
trace time from ``jax.default_backend()`` and the shapes:

* The trunk-exit kernel (``ops/kernels/trunk_pool.py``, Pallas through
  Triton) runs only when the backend is ``gpu``, the ``use_pallas``
  switch is on (the trainers' default; ``--no_pallas`` turns it off for
  A/B timing) and the widths fit it. Everywhere else the plain path runs.
* Interpret mode runs only when a caller passes
  ``use_pallas(interpret=True)`` explicitly, which is how the CPU tests
  reach the kernel. No code path picks it on its own.

Everything else is plain jnp: XLA fuses the BN/activation epilogues and
hands the matmuls to cuBLAS.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds.models import core

_state = threading.local()


def pallas_enabled() -> bool:
    """The ``use_pallas`` switch (off outside any context)."""
    return getattr(_state, "use_pallas", False)


def interpret_mode() -> bool:
    return getattr(_state, "interpret", False)


def kernel_route(c_in: int, c_out: int) -> bool:
    """True when ``linear_bn_maxpool`` takes the trunk-exit kernel for a
    ``c_in -> c_out`` layer: the switch is on, the widths fit, and the
    backend is a GPU (or a test asked for interpret mode)."""
    from adversarial_learning_on_pointclouds.ops.kernels import trunk_pool

    return (pallas_enabled() and trunk_pool.shapes_ok(c_in, c_out)
            and (interpret_mode() or jax.default_backend() == "gpu"))


def current_paths() -> tuple:
    """The trace-time route flags as a hashable tuple — (pallas,
    interpret, mixed-precision dtype name or None).

    The flags live in thread-locals read at TRACE time, so they are
    invisible to ``jax.jit``'s cache key on their own: toggling a context
    between calls of the same jitted step would silently reuse the
    previously traced path. Every jitted step therefore captures
    ``current_paths()`` at call time and threads it through as a static
    argument, re-establishing it during tracing via ``path_context``.
    """
    cd = core.compute_dtype()
    return (pallas_enabled(), interpret_mode(),
            None if cd is None else jnp.dtype(cd).name)


@contextlib.contextmanager
def _switch(enabled: bool, interpret: bool):
    prev = (pallas_enabled(), interpret_mode())
    _state.use_pallas, _state.interpret = enabled, interpret
    try:
        yield
    finally:
        _state.use_pallas, _state.interpret = prev


@contextlib.contextmanager
def path_context(paths: tuple):
    """Re-establish a ``current_paths()`` capture (used inside jitted
    functions so the traced path matches the static cache key exactly)."""
    pallas, interpret, mp_name = paths
    with _switch(pallas, interpret), \
            core.mixed_precision(dtype=mp_name or jnp.bfloat16,
                                 enabled=mp_name is not None):
        yield


def use_pallas(enabled: bool = True, *, interpret: bool = False):
    """Allow the kernel route within the context (it still runs only on
    a GPU backend, or in interpret mode when ``interpret=True``). Flags
    are read at *trace* time, so the context must wrap the ``jax.jit``
    tracing of the step."""
    return _switch(enabled, enabled and interpret)


def _act(x: jnp.ndarray, act: Optional[str]) -> jnp.ndarray:
    if act is None:
        return x
    if act == "relu":
        return jnp.maximum(x, 0)
    if act == "leaky_relu":
        return core.leaky_relu(x, 0.2)
    raise ValueError(f"unknown activation {act!r}")


# ---------------------------------------------------------------------------
# Shared-MLP block: y = act(bn(x @ w + b))
# ---------------------------------------------------------------------------

def linear_bn_act(dense_p, bn_p, bn_s, x: jnp.ndarray, train: bool,
                  act: Optional[str] = "relu",
                  ) -> Tuple[jnp.ndarray, dict]:
    """One shared-MLP block: pointwise matmul + BatchNorm + activation.

    Replaces the reference's ``relu(bn(conv1d(x)))`` pattern
    (``upstream:pointnet/model.py``, SURVEY.md §2.3). ``x`` is ``[B, N, C]``
    or ``[B, C]``; the matmul contracts the trailing channel axis.
    Training uses batch statistics over (batch, points); eval folds the
    running statistics into the matmul's scale and shift. XLA fuses the
    normalisation and activation into the matmul's epilogue either way.
    """
    if train:
        z = core.dense(dense_p, x)
        z, new_s = core.batch_norm(bn_p, bn_s, z, train=True)
        return _act(z, act), new_s
    w, shift, scale = folded_affine(dense_p, bn_p, bn_s)
    return _act(core.matmul(x, w * scale) + shift, act), bn_s


def linear_bn_act_pair(dense_p, bn_p, bn_s, x_a: jnp.ndarray,
                       x_b: jnp.ndarray, act: Optional[str] = "relu",
                       ) -> Tuple[jnp.ndarray, jnp.ndarray, dict]:
    """TRAIN-mode ``linear_bn_act`` on TWO same-shape streams with ONE
    batched ``[2B, N, C]`` matmul and PER-STREAM BN statistics
    (``core.batch_norm_grouped``, EMA chained a -> b — the exact
    statistics of two sequential calls). The ``--paired_conv1`` option."""
    z = core.dense(dense_p, jnp.concatenate([x_a, x_b], axis=0))
    z, new_s = core.batch_norm_grouped(bn_p, bn_s, z, True, groups=2)
    h = _act(z, act)
    b = x_a.shape[0]
    return h[:b], h[b:], new_s


def folded_affine(dense_p, bn_p, bn_s):
    """Fold BN running stats into (w, shift, scale) for eval:
    ``act((x @ w) * scale + shift)`` == ``act(bn(x @ w + b))``."""
    inv = jax.lax.rsqrt(bn_s["var"] + core.BN_EPS)
    scale = bn_p["scale"] * inv
    shift = bn_p["bias"] - bn_s["mean"] * scale
    return dense_p["w"], dense_p["b"] * scale + shift, scale


def linear_act(dense_p, x: jnp.ndarray, act: Optional[str] = None,
               ) -> jnp.ndarray:
    """Pointwise matmul + optional activation (no BN) — discriminator
    blocks."""
    return _act(core.dense(dense_p, x), act)


# ---------------------------------------------------------------------------
# Trunk exit: max-pool over the points of bn(x @ w + b)
# ---------------------------------------------------------------------------

def max_points(x: jnp.ndarray) -> jnp.ndarray:
    """``max`` over the point axis: ``[B, N, C] -> [B, C]``, the
    reference's ``torch.max(x, 2)`` symmetric function."""
    return jnp.max(x, axis=1)


def linear_bn_maxpool(dense_p, bn_p, bn_s, x: jnp.ndarray, train: bool,
                      ) -> Tuple[jnp.ndarray, dict]:
    """``max_n bn(x @ w + b)``: the last layer of every PointNet trunk
    and its symmetric pool, ``[B, N, C_in] -> [B, C_out]``.

    The plain route is ``linear_bn_act`` + ``max_points``. The kernel
    route (``kernel_route``) gives the same values and gradients without
    the ``[B, N, C_out]`` tensor (``ops/kernels/trunk_pool.py``).
    Callers that want ``max(relu(.))`` apply the ReLU to the pooled
    vector: ReLU is monotone, so ``max(relu(y)) == relu(max(y))``.
    """
    c_in, c_out = dense_p["w"].shape
    if not kernel_route(c_in, c_out):
        z, new_s = linear_bn_act(dense_p, bn_p, bn_s, x, train, act=None)
        return max_points(z), new_s
    from adversarial_learning_on_pointclouds.ops.kernels import trunk_pool

    if not train:
        w, shift, scale = folded_affine(dense_p, bn_p, bn_s)
        return trunk_pool.maxpool_eval(x, w * scale, shift,
                                       interpret=interpret_mode()), bn_s
    pooled, mean, var = trunk_pool.bn_maxpool_train(
        x, dense_p["w"], dense_p["b"], bn_p["scale"], bn_p["bias"],
        interpret=interpret_mode())
    return pooled, _ema_stats(bn_s, mean, var, m=x.shape[0] * x.shape[1])


def _ema_stats(s, batch_mean, batch_var_biased, m: int):
    """torch-style running-stat update from batch statistics taken over
    ``m`` rows (``core.batch_norm``'s update, for statistics computed
    elsewhere)."""
    unbiased = batch_var_biased * (m / max(m - 1, 1))
    mom = core.BN_MOMENTUM
    return {
        "mean": (1.0 - mom) * s["mean"]
                + mom * jax.lax.stop_gradient(batch_mean),
        "var": (1.0 - mom) * s["var"]
               + mom * jax.lax.stop_gradient(unbiased),
    }


def batched_transform(x: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Apply a per-cloud ``k x k`` transform: the reference's
    ``torch.bmm(points, trans)`` (T-Net apply)."""
    return core.matmul(x, t)
