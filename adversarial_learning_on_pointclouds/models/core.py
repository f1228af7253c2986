"""Functional layer primitives with PyTorch-compatible semantics.

The framework stores parameters and BatchNorm running statistics as plain
pytrees (nested dicts of ``jnp.ndarray``), applied by pure functions. This
keeps every model trivially jittable/vmappable/shardable and makes swapping
the compute path between plain XLA and a hand-written kernel a pure
dispatch decision (see ``ops/dispatch.py``).

Parity notes (SURVEY.md §7 "hard parts" #3):

* Initializers reproduce ``torch.nn.Conv1d``/``Linear`` defaults —
  kaiming-uniform with ``a=sqrt(5)`` on weights (which reduces to
  ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``) and the same bound for biases —
  so fixed-seed training trajectories are comparable-from-init with the
  reference (``BASELINE.json:5`` "bit-comparable logits on fixed seeds").
* BatchNorm follows ``torch.nn.BatchNorm1d`` defaults: eps=1e-5,
  momentum=0.1, running stats updated as ``(1-m)*old + m*batch`` with the
  *unbiased* batch variance stored but the *biased* variance used for
  normalization during training.
* A ``Conv1d(c_in, c_out, kernel_size=1)`` over ``[B, C, N]`` is exactly a
  per-point matmul; we keep the channel-last layout ``[B, N, C]`` so the
  contraction is over the contiguous trailing axis.

Reference architecture source: ``upstream:pointnet/model.py`` (see
SURVEY.md §2.3; the mount at /root/reference was empty, so citations are to
the surveyed lineage).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

Params = Dict[str, Any]
BnState = Dict[str, Any]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# A float32 matmul may run at reduced precision on an accelerator (TF32
# on a GPU) unless asked otherwise; the parity contract
# (BASELINE.json:5 "bit-comparable logits on fixed seeds") needs true fp32
# accumulation, so every matmul in the framework passes this explicitly.
# Throughput configs opt into bf16 inputs via ``mixed_precision()``.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST

_mp_state = __import__("threading").local()


def compute_dtype():
    """Matmul input dtype under the mixed-precision scope (None = fp32)."""
    return getattr(_mp_state, "dtype", None)


class mixed_precision:
    """Trace-time scope: run matmul inputs in bf16 (fp32 accumulation).

    Classic mixed precision — params, BN statistics, reductions and
    activations stay fp32; only the matmul operands are cast. Wrap the jit
    tracing of the step (like ``ops.use_pallas``); expect ~bf16-level
    (1e-2 relative) deviation from the fp32 path, with the matmuls on
    the bf16 tensor-core rate.
    """

    def __init__(self, dtype=jnp.bfloat16, enabled: bool = True):
        self._dtype = jnp.dtype(dtype) if enabled else None

    def __enter__(self):
        self._prev = compute_dtype()
        _mp_state.dtype = self._dtype
        return self

    def __exit__(self, *exc):
        _mp_state.dtype = self._prev
        return False


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Precision-pinned (or mixed-precision) matmul for the model layer."""
    cd = compute_dtype()
    if cd is not None and a.dtype == jnp.float32:
        return jnp.matmul(a.astype(cd), b.astype(cd),
                          preferred_element_type=jnp.float32)
    return jnp.matmul(a, b, precision=MATMUL_PRECISION,
                      preferred_element_type=a.dtype)


# ---------------------------------------------------------------------------
# Initializers (torch default semantics)
# ---------------------------------------------------------------------------

def torch_linear_init(key: jax.Array, fan_in: int, fan_out: int,
                      dtype=jnp.float32) -> Params:
    """``torch.nn.Linear``/``Conv1d(k=1)`` default init.

    Weight: kaiming_uniform(a=sqrt(5)) == U(-b, b) with b = 1/sqrt(fan_in).
    Bias:   U(-b, b) with the same bound.
    Weight is stored ``[fan_in, fan_out]`` (transposed vs torch's
    ``[out, in]``) so application is ``x @ w + b``.
    """
    kw, kb = jax.random.split(key)
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    w = jax.random.uniform(kw, (fan_in, fan_out), dtype, -bound, bound)
    b = jax.random.uniform(kb, (fan_out,), dtype, -bound, bound)
    return {"w": w, "b": b}


def bn_init(num_features: int, dtype=jnp.float32) -> Tuple[Params, BnState]:
    """``torch.nn.BatchNorm1d`` default: scale=1, bias=0, mean=0, var=1."""
    params = {
        "scale": jnp.ones((num_features,), dtype),
        "bias": jnp.zeros((num_features,), dtype),
    }
    state = {
        "mean": jnp.zeros((num_features,), dtype),
        "var": jnp.ones((num_features,), dtype),
    }
    return params, state


# ---------------------------------------------------------------------------
# Apply functions
# ---------------------------------------------------------------------------

def dense(p: Params, x: jnp.ndarray) -> jnp.ndarray:
    """Per-point / per-row affine map: ``x @ w + b``.

    Works for both ``[B, C]`` (torch Linear) and ``[B, N, C]`` (torch
    Conv1d(kernel=1) in channel-last layout).
    """
    return matmul(x, p["w"]) + p["b"]


def batch_norm(p: Params, s: BnState, x: jnp.ndarray, train: bool,
               momentum: float = BN_MOMENTUM, eps: float = BN_EPS,
               ) -> Tuple[jnp.ndarray, BnState]:
    """BatchNorm over all axes except the last (channel) axis.

    Matches ``torch.nn.BatchNorm1d`` on ``[B, C]`` and ``[B, C, N]`` inputs
    (ours are channel-last ``[B, N, C]``): statistics are computed over the
    batch *and* point axes. Under data-parallel sharding the reductions are
    global — XLA inserts the cross-chip ``psum`` — so DP training matches
    the reference's single-device statistics exactly (SURVEY.md §7 hard
    part #2).
    """
    if train:
        axes = tuple(range(x.ndim - 1))
        # One-pass moments: jnp.var reads x a second time after the mean
        # (profiled ~1.5 ms/step of stat-reduction fusions over the
        # [B,N,64] conv1 layers); E[x^2]-E[x]^2 lets XLA fuse both
        # reductions into a single read. Raw E[x^2]-E[x]^2 cancels
        # catastrophically when |mean| >> std (e.g. --no_normalize with
        # clouds in an offset world frame: mean^2/var ~ 1e6 eats ~all
        # fp32 bits), so the moments are taken about the RUNNING mean —
        # var(x) = E[(x-c)^2] - E[x-c]^2 for any constant c; c tracks
        # the activation mean after a few updates, the shift fuses into
        # the same single read, and at init (c = 0) this is bitwise the
        # raw form. (The Pallas training kernels keep raw one-pass
        # moments: their inputs are post-BN activations, zero-mean by
        # construction.)
        c = jax.lax.stop_gradient(s["mean"])
        xc = x - c
        mean_c = jnp.mean(xc, axis=axes)
        m2 = jnp.mean(jnp.square(xc), axis=axes)
        var = jnp.maximum(m2 - jnp.square(mean_c), 0.0)
        mean = mean_c + c
        n = x.size // x.shape[-1]
        unbiased = var * (n / max(n - 1, 1))
        new_s = {
            "mean": (1.0 - momentum) * s["mean"] + momentum * mean,
            "var": (1.0 - momentum) * s["var"] + momentum * unbiased,
        }
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = jax.lax.rsqrt(var + eps)
    y = (x - mean) * (inv * p["scale"]) + p["bias"]
    return y, new_s


def batch_norm_grouped(p: Params, s: BnState, x: jnp.ndarray, train: bool,
                       groups: int, momentum: float = BN_MOMENTUM,
                       eps: float = BN_EPS) -> Tuple[jnp.ndarray, BnState]:
    """Per-group BatchNorm over ``groups`` contiguous row-blocks of
    ``x: [G*B, C]``.

    Each block is normalized with ITS OWN batch statistics and the
    running stats are EMA-chained block 0 -> G-1 — the exact statistics
    of ``groups`` sequential ``batch_norm`` calls on the blocks. The
    cross-stream-batched T-Net fc head (``--paired_heads``) uses this to
    keep the matmuls batched ``[2B, C]`` while preserving the
    reference's per-stream BN semantics (the only fp-level departure
    from sequential calls is the centering constant: sequential block 2
    centers its one-pass moments about the post-block-1 running mean;
    here both blocks center about the incoming one — a rounding-only
    difference, see ``batch_norm``'s moment notes). ``groups=1`` (and
    eval mode, where running stats make grouping vacuous) defers to
    ``batch_norm``.
    """
    if not train or groups == 1:
        return batch_norm(p, s, x, train, momentum, eps)
    gb, c = x.shape[0], x.shape[-1]
    b = gb // groups
    cc = jax.lax.stop_gradient(s["mean"])
    # [G, B, C] (fc heads) or [G, B, N, C] (per-point conv layers under
    # --paired_conv1); statistics reduce over every per-group axis
    # except channels — matching batch_norm's (batch, points) reduction.
    xc = (x - cc).reshape((groups, b) + x.shape[1:])
    axes = tuple(range(1, xc.ndim - 1))
    mean_c = jnp.mean(xc, axis=axes, keepdims=True)         # [G, 1.., C]
    m2 = jnp.mean(jnp.square(xc), axis=axes, keepdims=True)
    var = jnp.maximum(m2 - jnp.square(mean_c), 0.0)         # [G, 1.., C]
    inv = jax.lax.rsqrt(var + eps)
    y = ((xc - mean_c) * (inv * p["scale"]) + p["bias"]).reshape(x.shape)
    mean = (mean_c + cc).reshape(groups, c)
    n = xc.size // (groups * c)  # rows behind each group's moments
    unbiased = (var * (n / max(n - 1, 1))).reshape(groups, c)
    new_mean, new_var = s["mean"], s["var"]
    for i in range(groups):
        new_mean = (1.0 - momentum) * new_mean + momentum * mean[i]
        new_var = (1.0 - momentum) * new_var + momentum * unbiased[i]
    return y, {"mean": new_mean, "var": new_var}


def dropout(x: jnp.ndarray, rate: float, rng: jax.Array,
            train: bool) -> jnp.ndarray:
    """Inverted dropout, torch semantics (scale by 1/(1-p) at train time)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(rng, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


def leaky_relu(x: jnp.ndarray, negative_slope: float = 0.2) -> jnp.ndarray:
    return jnp.where(x >= 0, x, negative_slope * x)
