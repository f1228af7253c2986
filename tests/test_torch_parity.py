"""Golden-logit parity vs. a torch-CPU rendition of the reference.

Builds each reference module in stock torch (``tests/torch_ref.py``),
copies the JAX model's weights into it, and asserts the outputs agree to
<=1e-5 fp32 on fixed inputs (``BASELINE.json:5`` "bit-comparable logits on
fixed seeds"; SURVEY.md §4 "Numerical parity vs. PyTorch"). Eval mode
(running BN stats, no dropout) for exact comparability; a separate test
pins train-mode BN semantics layer-by-layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_learning_on_pointclouds.models import (
    apply_classifier, apply_discriminator, apply_segmenter, apply_tnet,
    core, init_classifier, init_discriminator, init_segmenter, init_tnet,
)
from tests import torch_ref

B, N = 4, 96
ATOL = 1e-5

torch.set_default_dtype(torch.float32)
torch.manual_seed(0)


def _points(key=1):
    return np.asarray(
        jax.random.normal(jax.random.PRNGKey(key), (B, N, 3)),
        dtype=np.float32)


def test_tnet_parity(rng_key):
    params, state = init_tnet(rng_key, k=3)
    m = torch_ref.STNkdTorch(3).eval()
    torch_ref.load_tnet(params, state, m)
    x = _points()
    t_jax, _ = apply_tnet(params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        t_torch = m(torch.from_numpy(x).transpose(2, 1))
    np.testing.assert_allclose(np.asarray(t_jax), t_torch.numpy(), atol=ATOL)


@pytest.mark.parametrize("ft", [False, True])
def test_classifier_parity(rng_key, ft):
    params, state = init_classifier(rng_key, 40, feature_transform=ft)
    m = torch_ref.PointNetClsTorch(40, feature_transform=ft).eval()
    torch_ref.load_classifier(params, state, m)
    x = _points()
    logp_jax, trans_j, _, _ = apply_classifier(
        params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        logp_t, trans_t, _ = m(torch.from_numpy(x).transpose(2, 1))
    np.testing.assert_allclose(np.asarray(logp_jax), logp_t.numpy(), atol=ATOL)
    np.testing.assert_allclose(np.asarray(trans_j), trans_t.numpy(), atol=ATOL)


@pytest.mark.parametrize("ft", [False, True])
def test_segmenter_parity(rng_key, ft):
    params, state = init_segmenter(rng_key, 50, feature_transform=ft)
    m = torch_ref.PointNetDenseClsTorch(50, feature_transform=ft).eval()
    torch_ref.load_segmenter(params, state, m)
    x = _points()
    logp_jax, _, tf_j, _ = apply_segmenter(
        params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        logp_t, _, tf_t = m(torch.from_numpy(x).transpose(2, 1))
    np.testing.assert_allclose(np.asarray(logp_jax), logp_t.numpy(), atol=ATOL)
    if ft:
        np.testing.assert_allclose(np.asarray(tf_j), tf_t.numpy(), atol=ATOL)


def test_discriminator_parity(rng_key):
    params = init_discriminator(rng_key, 50)
    m = torch_ref.FCDiscriminatorTorch(50).eval()
    torch_ref.load_discriminator(params, m)
    probs = np.asarray(jax.nn.softmax(
        jax.random.normal(jax.random.PRNGKey(3), (B, N, 50)), -1),
        dtype=np.float32)
    out_jax = apply_discriminator(params, jnp.asarray(probs))
    with torch.no_grad():
        out_t = m(torch.from_numpy(probs).transpose(2, 1))
    np.testing.assert_allclose(np.asarray(out_jax)[..., 0],
                               out_t.numpy()[:, 0, :], atol=ATOL)


def test_batchnorm_train_semantics_match_torch():
    """Train-mode BN: normalization uses biased batch var; running stats
    use unbiased var with momentum 0.1 — exactly torch.nn.BatchNorm1d."""
    c = 8
    p, s = core.bn_init(c)
    p = {"scale": jnp.asarray(np.random.default_rng(0)
                              .uniform(0.5, 1.5, c).astype(np.float32)),
         "bias": jnp.asarray(np.random.default_rng(1)
                             .uniform(-0.5, 0.5, c).astype(np.float32))}
    x = np.random.default_rng(2).standard_normal((B, N, c)).astype(np.float32)

    y_jax, new_s = core.batch_norm(p, s, jnp.asarray(x), train=True)

    bn = torch.nn.BatchNorm1d(c)
    bn.weight.data = torch.from_numpy(np.asarray(p["scale"]).copy())
    bn.bias.data = torch.from_numpy(np.asarray(p["bias"]).copy())
    bn.train()
    y_t = bn(torch.from_numpy(x).transpose(2, 1)).transpose(2, 1)
    np.testing.assert_allclose(np.asarray(y_jax), y_t.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(new_s["mean"]),
                               bn.running_mean.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(new_s["var"]),
                               bn.running_var.numpy(), atol=1e-5)


def test_nll_matches_torch():
    logp = np.log(np.random.default_rng(0).dirichlet(
        np.ones(5), size=(B,)).astype(np.float32))
    labels = np.array([0, 2, 4, 1])
    from adversarial_learning_on_pointclouds import losses
    v_jax = float(losses.nll_loss(jnp.asarray(logp), jnp.asarray(labels)))
    v_t = float(torch.nn.functional.nll_loss(
        torch.from_numpy(logp), torch.from_numpy(labels)))
    assert v_jax == pytest.approx(v_t, abs=1e-6)


def test_bce_matches_torch():
    from adversarial_learning_on_pointclouds import losses
    z = np.random.default_rng(0).standard_normal((B, N)).astype(np.float32)
    for target in (0.0, 1.0):
        v_jax = float(losses.bce_with_logits(jnp.asarray(z), target))
        v_t = float(torch.nn.functional.binary_cross_entropy_with_logits(
            torch.from_numpy(z), torch.full((B, N), target)))
        assert v_jax == pytest.approx(v_t, abs=1e-6)


def test_init_distribution_matches_torch_defaults(rng_key):
    """Our init draws from the same U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    family as torch's Conv1d/Linear defaults (kaiming_uniform a=sqrt(5))."""
    p = core.torch_linear_init(rng_key, 128, 256)
    bound = 1.0 / np.sqrt(128)
    w = np.asarray(p["w"])
    assert w.min() >= -bound and w.max() <= bound
    assert w.max() > 0.9 * bound  # actually fills the range
    ref = torch.nn.Conv1d(128, 256, 1)
    tw = ref.weight.detach().numpy()
    assert abs(w.std() - tw.std()) < 0.05 * tw.std()
