"""Compiled trunk-exit kernel vs. the plain route, on the GPU (marker
``gpu``).

These tests need a card and skip elsewhere; whether one is present is
decided inside the ``gpu`` fixture. ``python chip_smoke.py`` runs them on
the card (in its own process, through ``pytest.main``), at the config-4
widths: batch 32, N = 2048 and the reference's N = 2500, a 64 -> 128 ->
1024 trunk (conv2 + BN2 + ReLU, then conv3 + BN3 + max-pool).

Tolerances: fp32 at ``Precision.HIGHEST`` on both sides, max|d| <=
1e-4 * max|ref|; bf16 operands with fp32 accumulation, <= 2e-2 *
max|ref|. Pooled values and gradients are compared, never winner
indices, which can flip at near-ties. A float32 product on a GPU runs in
TF32 (about three decimal digits) unless a precision is asked for, so
the fp32 case pins HIGHEST on both sides.
"""

import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.gpu

TOL = {False: 1e-4, True: 2e-2}


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")


def _trunk(n, b=32, seed=0):
    from adversarial_learning_on_pointclouds.models import core

    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    x = jax.random.normal(keys[0], (b, n, 64), jnp.float32)
    params = {"conv2": core.torch_linear_init(keys[1], 64, 128),
              "conv3": core.torch_linear_init(keys[2], 128, 1024)}
    for i, c in ((2, 128), (3, 1024)):
        params[f"bn{i}"], _ = core.bn_init(c)
    state = {f"bn{i}": core.bn_init(c)[1] for i, c in ((2, 128), (3, 1024))}
    ct = jax.random.normal(keys[3], (b, 1024), jnp.float32)
    return x, params, state, ct


def _apply(params, state, x, train):
    from adversarial_learning_on_pointclouds.ops import dispatch

    h, _ = dispatch.linear_bn_act(params["conv2"], params["bn2"],
                                  state["bn2"], x, train, "relu")
    g, _ = dispatch.linear_bn_maxpool(params["conv3"], params["bn3"],
                                      state["bn3"], h, train)
    return g


def trunk_parity(n, bf16, train=True):
    """``{name: max|kernel - plain| / max|plain|}`` for the pooled output
    and (train) the gradients of ``sum(pooled * ct)`` w.r.t. the input and
    every weight that reaches the loss (the pre-BN biases get only
    rounding noise, BN removes them)."""
    from adversarial_learning_on_pointclouds.models import core
    from adversarial_learning_on_pointclouds.ops import dispatch

    x, params, state, ct = _trunk(n)

    def loss(params, x):
        g = _apply(params, state, x, train)
        return jnp.sum(g * ct), g

    out = {}
    for route in (True, False):
        with dispatch.use_pallas(route), core.mixed_precision(enabled=bf16):
            assert dispatch.kernel_route(128, 1024) is route
            if train:
                f = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True))
                (_, g), (dp, dx) = f(params, x)
                out[route] = {"pooled": g, "dx": dx, "dw2": dp["conv2"]["w"],
                              "dgamma2": dp["bn2"]["scale"],
                              "dbeta2": dp["bn2"]["bias"],
                              "dw3": dp["conv3"]["w"],
                              "dgamma3": dp["bn3"]["scale"],
                              "dbeta3": dp["bn3"]["bias"]}
            else:
                out[route] = {"pooled": jax.jit(
                    lambda p, x: _apply(p, state, x, False))(params, x)}
    return {k: float(jnp.max(jnp.abs(out[True][k] - out[False][k]))
                     / jnp.max(jnp.abs(out[False][k])))
            for k in out[False]}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [2048, 2500])
def test_trunk_kernel_compiled_train_parity(gpu, n, bf16):
    ratios = trunk_parity(n, bf16)
    print(f"trunk train parity B=32 N={n} {'bf16' if bf16 else 'fp32'} "
          f"(max|d|/max|ref|, bound {TOL[bf16]:g}): "
          + " ".join(f"{k}={v:.2e}" for k, v in ratios.items()))
    assert all(v <= TOL[bf16] for v in ratios.values()), ratios


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [2048, 2500])
def test_trunk_kernel_compiled_eval_parity(gpu, n, bf16):
    ratios = trunk_parity(n, bf16, train=False)
    print(f"trunk eval parity B=32 N={n} {'bf16' if bf16 else 'fp32'}: "
          f"pooled={ratios['pooled']:.2e} (bound {TOL[bf16]:g})")
    assert ratios["pooled"] <= TOL[bf16], ratios
