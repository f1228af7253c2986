"""Trunk exit: ``max_n bn(h @ w + b)`` without the ``[B, N, C]`` tensor.

Every PointNet trunk (STN3d, STNkd, the encoder) ends in a 128 -> 1024
pointwise layer, a BatchNorm and a max-pool over the points. The plain
XLA route writes ``z = h @ w + b`` (``[B, N, 1024]``, 268 MB in fp32 at
batch 32 x 2048 points) and reads it back for the BN statistics, the
normalisation, the pool and about five more times in backward. This
module never forms it:

* **Extrema kernel** (Pallas, Triton route). One program per
  ``(cloud, channel block)`` walks the point axis in tiles, computes
  ``z`` tile by tile with ``pl.dot`` and keeps the running max, min and
  their first indices. The point tail is masked, so any N works. BN is a
  per-channel affine, so ``max_n bn(z) = s >= 0 ? s*max z + t : s*min z
  + t`` comes from the extrema alone.
* **BN statistics through the Gram matrix** (plain jnp). With the mean
  ``hbar`` and the centred Gram matrix ``Cov = (h - hbar)^T (h - hbar)/M``
  over all M = B*N rows (``h`` is 128 wide), ``mean(z) = hbar @ w + b``
  and ``var(z) = diag(w^T Cov w)``.
* **Backward** (plain jnp, ``jax.custom_vjp``). The pooled cotangent is
  one-hot over the points, so the BN backward
  ``dz = s*(dy - mean(dy) - zhat*mean(dy*zhat))`` splits into a sparse
  winner term and channel-scalar terms. ``dw``, ``db`` and ``dh`` then
  need only ``G``, ``w``, the winner rows of ``h`` and a scatter of
  ``B x C`` winner rows. The statistics are differentiated too (their
  cotangents fold into the same channel scalars), so the gradient is
  that of the plain composition.

The kernel runs compiled only on a GPU; ``interpret=True`` runs it on
the CPU for tests. ``ops/dispatch.py`` decides when it is used.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from adversarial_learning_on_pointclouds.models import core

TILE_N = 64         # points per inner-loop tile
BLOCK_C = 128       # output channels per program
_HIGHEST = lax.Precision.HIGHEST


def shapes_ok(c_in: int, c_out: int) -> bool:
    """Widths the kernel takes: a power-of-two input width of at least 16
    (``pl.dot``'s minimum) and whole channel blocks."""
    return (c_in >= 16 and c_in & (c_in - 1) == 0
            and c_out % BLOCK_C == 0)


# ---------------------------------------------------------------------------
# Extrema kernel
# ---------------------------------------------------------------------------

def _extrema_kernel(h_ref, w_ref, b_ref, mx_ref, mn_ref, imx_ref, imn_ref,
                    *, n: int, precision):
    bc = w_ref.shape[1]
    w = w_ref[...]
    bias = b_ref[...]

    def body(t, carry):
        mx, mn, imx, imn = carry
        rows = t * TILE_N + jnp.arange(TILE_N, dtype=jnp.int32)
        valid = (rows < n)[:, None]
        h = plgpu.load(h_ref.at[pl.ds(t * TILE_N, TILE_N), :], mask=valid,
                       other=0.0)
        z = pl.dot(h, w, precision=precision) + bias[None, :]
        z_hi = jnp.where(valid, z, -jnp.inf)
        z_lo = jnp.where(valid, z, jnp.inf)
        t_mx = jnp.max(z_hi, axis=0)
        t_mn = jnp.min(z_lo, axis=0)
        # First row attaining the extremum (jnp.argmax's convention).
        a_mx = jnp.min(jnp.where(z_hi == t_mx[None, :], rows[:, None], n),
                       axis=0)
        a_mn = jnp.min(jnp.where(z_lo == t_mn[None, :], rows[:, None], n),
                       axis=0)
        up, down = t_mx > mx, t_mn < mn
        return (jnp.where(up, t_mx, mx), jnp.where(down, t_mn, mn),
                jnp.where(up, a_mx, imx), jnp.where(down, a_mn, imn))

    init = (jnp.full((bc,), -jnp.inf, jnp.float32),
            jnp.full((bc,), jnp.inf, jnp.float32),
            jnp.zeros((bc,), jnp.int32), jnp.zeros((bc,), jnp.int32))
    mx, mn, imx, imn = lax.fori_loop(0, pl.cdiv(n, TILE_N), body, init)
    mx_ref[...] = mx
    mn_ref[...] = mn
    imx_ref[...] = imx
    imn_ref[...] = imn


def _extrema_call(h, w, b, interpret: bool):
    bsz, n, c_in = h.shape
    c_out = w.shape[1]
    precision = _HIGHEST if h.dtype == jnp.float32 else None
    kernel = functools.partial(_extrema_kernel, n=n, precision=precision)
    cloud = pl.BlockSpec((None, BLOCK_C), lambda i, j: (i, j))
    return pl.pallas_call(
        kernel,
        grid=(bsz, c_out // BLOCK_C),
        in_specs=[pl.BlockSpec((None, n, c_in), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((c_in, BLOCK_C), lambda i, j: (0, j)),
                  pl.BlockSpec((BLOCK_C,), lambda i, j: (j,))],
        out_specs=[cloud] * 4,
        out_shape=[jax.ShapeDtypeStruct((bsz, c_out), jnp.float32)] * 2
        + [jax.ShapeDtypeStruct((bsz, c_out), jnp.int32)] * 2,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="trunk_pool_extrema",
    )(h, w, b.astype(jnp.float32))


def extrema(h, w, b, *, interpret: bool = False):
    """Per-cloud ``(max, min, argmax, argmin)`` over the points of
    ``h @ w + b``, each ``[B, C_out]``. ``h``/``w`` share a dtype (bf16
    operands accumulate in fp32; fp32 operands use IEEE products).

    Under a context mesh (``jax.set_mesh``) whose batch axes span several
    devices, the kernel runs per device on its shard of clouds inside
    ``shard_map``; GSPMD cannot partition a custom call."""
    call = functools.partial(_extrema_call, interpret=interpret)
    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty or mesh.size == 1:
        return call(h, w, b)
    from adversarial_learning_on_pointclouds.parallel.mesh import data_axes

    spec = jax.sharding.PartitionSpec(data_axes(mesh))
    rep = jax.sharding.PartitionSpec()
    return jax.shard_map(call, mesh=mesh, in_specs=(spec, rep, rep),
                         out_specs=spec, check_vma=False)(h, w, b)


# ---------------------------------------------------------------------------
# Train: BN with batch statistics + max-pool, custom VJP
# ---------------------------------------------------------------------------

def _dot32(a, b):
    """fp32-accumulated product; operands keep their dtype (bf16 operands
    are exact in fp32, so HIGHEST only matters for fp32 ones)."""
    return jnp.matmul(a, b.astype(a.dtype), precision=_HIGHEST,
                      preferred_element_type=jnp.float32)


def _operands(h, w):
    """The matmul operands, cast as ``core.matmul`` would cast them."""
    cd = core.compute_dtype()
    if cd is not None and h.dtype == jnp.float32:
        return h.astype(cd), w.astype(cd)
    return h, w.astype(h.dtype)


def _fwd(h, w, b, gamma, beta, interpret):
    hq, wq = _operands(h, w)
    bsz, n, c_in = hq.shape
    m = bsz * n
    flat = hq.reshape(m, c_in).astype(jnp.float32)
    hbar = jnp.sum(flat, axis=0) / m
    # Centred before the Gram product (two passes over the 128-wide h):
    # G/M - hbar hbar^T cancels catastrophically when |hbar| >> std(h).
    hc = flat - hbar
    cov = _dot32(hc.T, hc) / m
    w32 = wq.astype(jnp.float32)
    mean = _dot32(hbar, w32) + b
    var = jnp.maximum(jnp.sum(_dot32(cov, w32) * w32, axis=0), 0.0)
    inv = lax.rsqrt(var + core.BN_EPS)
    scale = gamma * inv
    shift = beta - mean * scale

    mx, mn, imx, imn = extrema(hq, wq, b, interpret=interpret)
    pos = scale >= 0
    ext = jnp.where(pos, mx, mn)
    idx = jnp.where(pos, imx, imn)
    pooled = ext * scale + shift
    res = (hq, w32, gamma, mean, inv, hbar, cov, ext, idx)
    return (pooled, mean, var), res


def _bwd(interpret, res, cts):
    del interpret
    hq, w32, gamma, mean, inv, hbar, cov, ext, idx = res
    d_pool, d_mean, d_var = cts
    bsz, n, c_in = hq.shape
    m = bsz * n
    scale = gamma * inv
    zhat_win = (ext - mean) * inv                     # [B, C]
    s1 = jnp.sum(d_pool, axis=0)                      # sum dy
    s2 = jnp.sum(d_pool * zhat_win, axis=0)           # sum dy * zhat
    win = scale * d_pool                              # sparse dz at winners
    # dz = win (at the winner rows) - coef - (hc @ w) * d_scale, with the
    # statistics' own cotangents folded into the two channel scalars.
    coef = scale * s1 / m - d_mean / m
    d_scale = inv * scale * s2 / m - 2.0 * d_var / m

    h_win = jax.vmap(lambda hb, ib: hb[ib])(hq, idx).astype(jnp.float32)
    dw = (jnp.einsum("bck,bc->kc", h_win, win, precision=_HIGHEST)
          - jnp.outer(hbar * m, coef)
          - _dot32(cov * m, w32) * d_scale)
    db = jnp.sum(win, axis=0) - m * coef

    proj = _dot32(w32 * d_scale, w32.T)               # w D w^T, [c_in, c_in]
    rows = (win[:, :, None] * w32.T[None]).astype(jnp.float32)
    dh = jax.vmap(lambda ib, vb: jnp.zeros((n, c_in), jnp.float32)
                  .at[ib].add(vb))(idx, rows)
    dh = dh - (_dot32(coef, w32.T) - _dot32(hbar, proj)) - _dot32(hq, proj)
    return dh, dw, db, s2, s1


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def _bn_maxpool(h, w, b, gamma, beta, interpret):
    return _fwd(h, w, b, gamma, beta, interpret)[0]


_bn_maxpool.defvjp(_fwd, _bwd)


def bn_maxpool_train(h, w, b, gamma, beta, *, interpret: bool = False):
    """``max_n BN_train(h @ w + b)`` with batch statistics over all B*N
    rows. Returns ``(pooled [B, C], mean [C], var_biased [C])``;
    differentiable in every input, statistics included. The custom VJP
    works in fp32 (its cotangents match fp32 inputs; the casts carry them
    back to other dtypes)."""
    f32 = [a.astype(jnp.float32) for a in (h, w, b, gamma, beta)]
    pooled, mean, var = _bn_maxpool(*f32, interpret)
    return pooled.astype(h.dtype), mean, var


def maxpool_eval(h, w, b, *, interpret: bool = False):
    """``max_n (h @ w + b)``: the eval trunk exit with BN folded into
    ``w``/``b`` by the caller. Forward only."""
    hq, wq = _operands(h, w)
    return extrema(hq, wq, b, interpret=interpret)[0].astype(h.dtype)
