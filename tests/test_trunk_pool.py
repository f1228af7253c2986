"""The trunk-exit kernel (``ops/kernels/trunk_pool.py``) against the plain
composition, and the route choice around it (``ops/dispatch.py``).

The kernel runs in interpreter mode here; ``test_kernel_lowers_for_cuda``
runs the Pallas -> Triton lowering for the GPU without a GPU, so a kernel
the Triton route cannot express fails on the CPU too. Compiled-kernel
parity at full width runs on the card (``chip_smoke.py``,
``tests/test_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adversarial_learning_on_pointclouds.models import core
from adversarial_learning_on_pointclouds.ops import dispatch
from adversarial_learning_on_pointclouds.ops.kernels import trunk_pool


def _inputs(b, n, c_in, c_out, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    h = np.maximum(rng.standard_normal((b, n, c_in)), 0.0) + offset
    w = rng.standard_normal((c_in, c_out)) / np.sqrt(c_in)
    bias = 0.1 * rng.standard_normal(c_out)
    gamma = 1.0 + 0.2 * rng.standard_normal(c_out)
    gamma[::7] *= -1.0            # negative BN scales pool the minimum
    beta = 0.1 * rng.standard_normal(c_out)
    return tuple(jnp.asarray(a, jnp.float32)
                 for a in (h, w, bias, gamma, beta))


def _plain(h, w, b, gamma, beta):
    """The plain route: matmul + train-mode BN + max over points."""
    z = core.matmul(h, w) + b
    c = z.shape[-1]
    y, _ = core.batch_norm({"scale": gamma, "bias": beta},
                           {"mean": jnp.zeros(c), "var": jnp.ones(c)}, z,
                           True)
    axes = (0, 1)
    return jnp.max(y, axis=1), jnp.mean(z, axes), jnp.var(z, axes)


def _kernel(h, w, b, gamma, beta):
    return trunk_pool.bn_maxpool_train(h, w, b, gamma, beta, interpret=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------------------
# Extrema kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,c_in,c_out,dtype", [
    (2, 64, 128, 256, jnp.float32),      # one full point tile
    (2, 100, 128, 128, jnp.float32),     # tail not a multiple of the tile
    (1, 2500, 128, 128, jnp.float32),    # the reference's seg N
    (3, 130, 64, 256, jnp.bfloat16),     # bf16 operands, narrow input
    (2, 1, 16, 128, jnp.float32),        # a single point
    (1, 2048, 128, 1024, jnp.bfloat16),  # config-4 widths
    (4, 65, 32, 128, jnp.float32),       # one row past a tile
    (2, 127, 128, 256, jnp.bfloat16),    # one row short of two tiles
    (1, 2500, 128, 1024, jnp.float32),   # seg N at config-4 widths
])
def test_extrema_kernel_matches_jnp(b, n, c_in, c_out, dtype):
    h, w, bias, _, _ = _inputs(b, n, c_in, c_out)
    h, w = h.astype(dtype), w.astype(dtype)
    mx, mn, imx, imn = trunk_pool.extrema(h, w, bias, interpret=True)
    z = jnp.matmul(h, w, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32) + bias
    np.testing.assert_allclose(mx, z.max(1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mn, z.min(1), rtol=1e-6, atol=1e-6)
    # The indices point at rows that attain the extrema.
    rows = jnp.arange(b)[:, None]
    cols = jnp.arange(c_out)[None, :]
    np.testing.assert_array_equal(z[rows, imx, cols], mx)
    np.testing.assert_array_equal(z[rows, imn, cols], mn)
    assert int(imx.max()) < n and int(imn.min()) >= 0


# ---------------------------------------------------------------------------
# Train: forward, Gram statistics, custom VJP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,bf16", [
    (2, 64, False), (3, 100, False), (1, 2500, False), (2, 100, True),
    (1, 2500, True),
])
def test_bn_maxpool_train_forward(b, n, bf16):
    args = _inputs(b, n, 128, 256, seed=1)
    with core.mixed_precision(enabled=bf16):
        got, want = _kernel(*args), _plain(*args)
    for g, w in zip(got, want):
        assert _rel(g, w) < (2e-3 if bf16 else 2e-6)


@pytest.mark.parametrize("offset", [0.0, 3.0, 30.0])
def test_gram_statistics_match_two_pass(offset):
    """Mean/variance through ``G = h^T h`` match the two-pass statistics
    of the materialized ``z``, also when ``h`` sits far from zero (the
    one-pass variance's cancellation case)."""
    h, w, bias, gamma, beta = _inputs(4, 96, 128, 256, seed=2,
                                      offset=offset)
    _, mean, var = _kernel(h, w, bias, gamma, beta)
    z = np.asarray(h, np.float64) @ np.asarray(w, np.float64) + np.asarray(
        bias, np.float64)
    assert _rel(mean, z.mean((0, 1))) < 1e-5
    assert _rel(var, z.var((0, 1))) < 1e-4


@pytest.mark.parametrize("b,n,dtype", [
    (2, 64, jnp.float32), (3, 100, jnp.float32), (1, 2500, jnp.float32),
    (2, 130, jnp.bfloat16),
])
def test_bn_maxpool_vjp_matches_autodiff(b, n, dtype):
    """The custom VJP == jax.grad of the plain composition, for the pooled
    output AND the statistics' own cotangents."""
    args = _inputs(b, n, 128, 256, seed=3)
    rng = np.random.default_rng(4)
    cts = [jnp.asarray(rng.standard_normal(s), jnp.float32)
           for s in ((b, 256), (256,), (256,))]

    def loss(fn):
        def f(*a):
            return sum(jnp.sum(o * c) for o, c in zip(fn(*a), cts))
        return f

    with core.mixed_precision(enabled=dtype == jnp.bfloat16):
        got = jax.grad(loss(_kernel), argnums=range(5))(*args)
        want = jax.grad(loss(_plain), argnums=range(5))(*args)
    tol = 2e-2 if dtype == jnp.bfloat16 else 1e-4
    for name, g, r in zip(("dh", "dw", "db", "dgamma", "dbeta"), got, want):
        if name == "db":   # zero up to rounding: BN removes the bias
            assert float(jnp.max(jnp.abs(g - r))) < 1e-3, name
            continue
        assert _rel(g, r) < tol, (name, _rel(g, r))


def test_maxpool_eval_matches_plain():
    h, w, bias, _, _ = _inputs(3, 100, 128, 256, seed=5)
    got = trunk_pool.maxpool_eval(h, w, bias, interpret=True)
    want = jnp.max(core.matmul(h, w) + bias, axis=1)
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("n", [2048, 2500])
def test_kernel_lowers_for_cuda(dtype, n):
    """Pallas -> Triton lowering of the config-4 trunk exit for the GPU,
    run on the CPU (cross-platform lowering; no GPU compile)."""
    h = jax.ShapeDtypeStruct((32, n, 128), dtype)
    w = jax.ShapeDtypeStruct((128, 1024), dtype)
    b = jax.ShapeDtypeStruct((1024,), jnp.float32)
    lowered = jax.jit(trunk_pool.extrema).trace(h, w, b).lower(
        lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "xla.gpu.triton" in text and "trunk_pool_extrema" in text


# ---------------------------------------------------------------------------
# Route choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,enabled,interpret,widths,want", [
    ("gpu", True, False, (128, 1024), True),
    ("gpu", False, False, (128, 1024), False),   # --no_pallas
    ("cpu", True, False, (128, 1024), False),    # never interpret by itself
    ("cpu", True, True, (128, 1024), True),      # a test asked for it
    ("gpu", True, False, (3, 1024), False),      # width pl.dot cannot take
    ("gpu", True, False, (128, 100), False),     # partial channel block
])
def test_kernel_route_choice(monkeypatch, backend, enabled, interpret,
                             widths, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with dispatch.use_pallas(enabled, interpret=interpret):
        assert dispatch.kernel_route(*widths) is want
    assert dispatch.kernel_route(*widths) is False   # off outside a context


def test_paths_key_carries_interpret_flag():
    """The jit-cache key changes with the interpret flag, so a step traced
    on one route is never reused on the other."""
    with dispatch.use_pallas(True):
        a = dispatch.current_paths()
    with dispatch.use_pallas(True, interpret=True):
        b = dispatch.current_paths()
        with dispatch.path_context(a):
            assert not dispatch.interpret_mode()
        assert dispatch.interpret_mode()
    assert a != b and a[:1] == b[:1]


def test_kernel_route_under_dp_mesh_matches_single_device():
    """Under a context mesh the kernel runs per device inside shard_map;
    the BN statistics stay global (GSPMD reduces them across devices)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from adversarial_learning_on_pointclouds.parallel import make_mesh

    args = _inputs(8, 64, 128, 256, seed=6)
    ct = jnp.asarray(np.random.default_rng(7).standard_normal((8, 256)),
                     jnp.float32)

    def f(h, w, b, g, be):
        pooled, mean, var = _kernel(h, w, b, g, be)
        return jnp.sum(pooled * ct) + jnp.sum(var), (pooled, mean, var)

    step = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    (_, single), d_single = step(*args)
    mesh = make_mesh(4)
    h = jax.device_put(args[0], NamedSharding(mesh, P("data")))
    with jax.set_mesh(mesh):
        (_, dp), d_dp = step(h, *args[1:])
    for a, b in zip(jax.tree_util.tree_leaves((dp, d_dp)),
                    jax.tree_util.tree_leaves((single, d_single))):
        assert _rel(a, b) < 1e-5


@pytest.mark.parametrize("c_in,c_out,ok", [
    (128, 1024, True), (64, 256, True), (16, 128, True),
    (3, 1024, False),      # pl.dot needs every dimension >= 16
    (96, 1024, False),     # not a power of two
    (128, 1000, False),    # partial channel block
])
def test_shapes_ok(c_in, c_out, ok):
    assert trunk_pool.shapes_ok(c_in, c_out) is ok


@pytest.mark.parametrize("output", ["pooled", "mean", "var"])
def test_vjp_of_each_output(output):
    """Each output's cotangent alone reaches every input as jax.grad of
    the plain composition sends it (the statistics are not
    stop-gradient)."""
    args = _inputs(2, 80, 128, 128, seed=8)
    i = ("pooled", "mean", "var").index(output)
    ct = jnp.asarray(np.random.default_rng(9).standard_normal(
        _plain(*args)[i].shape), jnp.float32)
    got = jax.grad(lambda *a: jnp.sum(_kernel(*a)[i] * ct),
                   argnums=(0, 1, 3, 4))(*args)
    want = jax.grad(lambda *a: jnp.sum(_plain(*a)[i] * ct),
                    argnums=(0, 1, 3, 4))(*args)
    for g, r in zip(got, want):
        assert float(jnp.max(jnp.abs(g - r))) <= 1e-4 * (
            1.0 + float(jnp.max(jnp.abs(r))))


def _model(name):
    from adversarial_learning_on_pointclouds.models import encoder, tnet

    key = jax.random.PRNGKey(10)
    if name == "encoder":
        p, s = encoder.init_encoder(key, feature_transform=True)
        return p, s, 3, lambda p, s, x, t: encoder.apply_encoder(
            p, s, x, t)[::3]
    k = 3 if name == "stn3d" else 64
    p, s = tnet.init_tnet(key, k)
    return p, s, k, tnet.apply_tnet


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["stn3d", "stnkd", "encoder"])
def test_model_trunk_route_parity(name, train):
    """STN3d, STNkd and the encoder through the dispatch route: the
    kernel route's outputs and BN state == the plain route's (batch 16
    keeps the fc heads' batch-axis BN from amplifying fp32 noise)."""
    params, state, k, apply = _model(name)
    x = jax.random.normal(jax.random.PRNGKey(11), (16, 96, k), jnp.float32)
    ref = apply(params, state, x, train)
    with dispatch.use_pallas(interpret=True):
        got = apply(params, state, x, train)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert float(jnp.max(jnp.abs(a - b))) <= 1e-4 * (
            1.0 + float(jnp.max(jnp.abs(b))))
