"""Round-trip test for reference ``.pth`` checkpoint migration: build the
torch rendition, save its state_dict, import into JAX, assert identical
logits — the full migration path a reference user would follow."""

import jax.numpy as jnp
import numpy as np
import torch

from adversarial_learning_on_pointclouds.models import (
    apply_classifier, apply_discriminator, apply_segmenter,
)
from adversarial_learning_on_pointclouds.utils import torch_import
from tests import torch_ref

B, N = 2, 64


def _pts():
    rng = np.random.default_rng(0)
    return rng.standard_normal((B, N, 3)).astype(np.float32)


def test_classifier_pth_roundtrip(tmp_path):
    m = torch_ref.PointNetClsTorch(40, feature_transform=True).eval()
    path = tmp_path / "cls.pth"
    torch.save(m.state_dict(), path)
    sd = torch_import.load_pth(str(path))
    params, state = torch_import.classifier_from_state_dict(sd)
    x = _pts()
    logp, _, _, _ = apply_classifier(params, state, jnp.asarray(x),
                                     train=False)
    with torch.no_grad():
        ref, _, _ = m(torch.from_numpy(x).transpose(2, 1))
    np.testing.assert_allclose(np.asarray(logp), ref.numpy(), atol=1e-5)


def test_segmenter_pth_roundtrip(tmp_path):
    m = torch_ref.PointNetDenseClsTorch(50, feature_transform=False).eval()
    path = tmp_path / "seg.pth"
    torch.save(m.state_dict(), path)
    params, state = torch_import.segmenter_from_state_dict(
        torch_import.load_pth(str(path)))
    x = _pts()
    logp, _, _, _ = apply_segmenter(params, state, jnp.asarray(x),
                                    train=False)
    with torch.no_grad():
        ref, _, _ = m(torch.from_numpy(x).transpose(2, 1))
    np.testing.assert_allclose(np.asarray(logp), ref.numpy(), atol=1e-5)


def test_discriminator_pth_roundtrip(tmp_path):
    m = torch_ref.FCDiscriminatorTorch(50).eval()
    path = tmp_path / "d.pth"
    torch.save(m.state_dict(), path)
    params = torch_import.discriminator_from_state_dict(
        torch_import.load_pth(str(path)))
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(50), size=(B, N)).astype(np.float32)
    out = apply_discriminator(params, jnp.asarray(probs))
    with torch.no_grad():
        ref = m(torch.from_numpy(probs).transpose(2, 1))
    np.testing.assert_allclose(np.asarray(out)[..., 0],
                               ref.numpy()[:, 0, :], atol=1e-5)


def test_classifier_pth_export_strict_load(tmp_path):
    """EXPORT direction (utils/torch_export.py): a model trained here
    saves as a reference-named .pth that torch loads with strict=True and
    reproduces our logits — the migration path back to the reference."""
    import jax

    from adversarial_learning_on_pointclouds.models import (
        init_classifier,
    )
    from adversarial_learning_on_pointclouds.utils import torch_export

    params, state = init_classifier(jax.random.PRNGKey(3), 40,
                                    feature_transform=True)
    path = str(tmp_path / "export_cls.pth")
    torch_export.save_pth(
        path, torch_export.classifier_state_dict(params, state))
    m = torch_ref.PointNetClsTorch(40, feature_transform=True)
    m.load_state_dict(torch.load(path, map_location="cpu"), strict=True)
    m.eval()
    x = _pts()
    logp, _, _, _ = apply_classifier(params, state, jnp.asarray(x),
                                     train=False)
    with torch.no_grad():
        ref, _, _ = m(torch.from_numpy(x).transpose(2, 1))
    np.testing.assert_allclose(np.asarray(logp), ref.numpy(), atol=1e-5)


def test_segmenter_discriminator_export_import_roundtrip(tmp_path):
    """Export -> import closes bit-exactly for the segmenter and D."""
    import jax

    from adversarial_learning_on_pointclouds.models import (
        init_discriminator, init_segmenter,
    )
    from adversarial_learning_on_pointclouds.utils import torch_export

    sp, ss = init_segmenter(jax.random.PRNGKey(4), 50,
                            feature_transform=True)
    path = str(tmp_path / "export_seg.pth")
    torch_export.save_pth(path, torch_export.segmenter_state_dict(sp, ss))
    p2, s2 = torch_import.segmenter_from_state_dict(
        torch_import.load_pth(path))
    for a, b in zip(jax.tree_util.tree_leaves((sp, ss)),
                    jax.tree_util.tree_leaves((p2, s2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    dp = init_discriminator(jax.random.PRNGKey(5), 50)
    dpath = str(tmp_path / "export_d.pth")
    torch_export.save_pth(dpath, torch_export.discriminator_state_dict(dp))
    m = torch_ref.FCDiscriminatorTorch(50)
    m.load_state_dict(torch.load(dpath, map_location="cpu"), strict=True)
    d2 = torch_import.discriminator_from_state_dict(
        torch_import.load_pth(dpath))
    for a, b in zip(jax.tree_util.tree_leaves(dp),
                    jax.tree_util.tree_leaves(d2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
