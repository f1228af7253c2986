"""Checkpoint/resume round-trip tests (SURVEY.md §5)."""

import jax
import jax.numpy as jnp
import numpy as np

from adversarial_learning_on_pointclouds.configs import (
    AdversarialConfig, ClassifyConfig,
)
from adversarial_learning_on_pointclouds.train import adversarial, classify
from adversarial_learning_on_pointclouds.utils import checkpoint

B, N = 4, 64


def _tree_equal(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))


def test_full_state_roundtrip(tmp_path):
    cfg = ClassifyConfig(num_classes=4, batch_size=B, num_points=N)
    tx = classify.make_tx(cfg, 1)
    state = classify.create_state(cfg, 1)
    pts = jnp.asarray(np.random.default_rng(0)
                      .standard_normal((B, N, 3)).astype(np.float32))
    labels = jnp.asarray((np.arange(B) % 4).astype(np.int32))
    state, _ = classify.train_step(state, pts, labels, cfg=cfg, tx=tx)

    checkpoint.save(str(tmp_path), 0, state)
    fresh = classify.create_state(cfg, 1)
    restored = checkpoint.restore(str(tmp_path), fresh)
    assert _tree_equal(restored.params, state.params)
    assert _tree_equal(restored.opt_state, state.opt_state)
    assert int(restored.step) == int(state.step)

    # Training continues identically from the restored state.
    s1, m1 = classify.train_step(state, pts, labels, cfg=cfg, tx=tx)
    s2, m2 = classify.train_step(restored, pts, labels, cfg=cfg, tx=tx)
    assert float(m1["loss"]) == float(m2["loss"])
    assert _tree_equal(s1.params, s2.params)


def test_latest_step_selection(tmp_path):
    cfg = ClassifyConfig(num_classes=4, batch_size=B, num_points=N)
    state = classify.create_state(cfg, 1)
    checkpoint.save(str(tmp_path), 0, state)
    checkpoint.save(str(tmp_path), 7, state)
    checkpoint.save(str(tmp_path), 3, state)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None


def test_params_only_resume_mirrors_reference(tmp_path):
    """--compat_resume semantics: params+BN restored, optimizer fresh."""
    cfg = ClassifyConfig(num_classes=4, batch_size=B, num_points=N)
    tx = classify.make_tx(cfg, 1)
    state = classify.create_state(cfg, 1)
    pts = jnp.asarray(np.random.default_rng(0)
                      .standard_normal((B, N, 3)).astype(np.float32))
    labels = jnp.asarray((np.arange(B) % 4).astype(np.int32))
    for _ in range(3):
        state, _ = classify.train_step(state, pts, labels, cfg=cfg, tx=tx)
    checkpoint.save(str(tmp_path), 3, state)

    fresh = classify.create_state(cfg, 1)
    warm = checkpoint.load_params_only(str(tmp_path), fresh)
    assert _tree_equal(warm.params, state.params)
    assert _tree_equal(warm.bn_state, state.bn_state)
    # Optimizer/step must be the FRESH ones (reference restarts them).
    assert int(warm.step) == 0
    assert _tree_equal(warm.opt_state, fresh.opt_state)


def test_gan_state_roundtrip(tmp_path):
    cfg = AdversarialConfig(num_parts=4, batch_size=B, num_points=N,
                            feature_transform=False)
    state = adversarial.create_state(cfg, 1)
    checkpoint.save(str(tmp_path), 0, state)
    restored = checkpoint.restore(str(tmp_path),
                                  adversarial.create_state(cfg, 1))
    assert _tree_equal(restored.g_params, state.g_params)
    assert _tree_equal(restored.d_params, state.d_params)


def test_async_saver_roundtrip_and_error_propagation(tmp_path):
    """AsyncSaver: (a) checkpoints written off-thread are durable and
    restorable after close(); (b) a writer-thread failure surfaces on
    close() instead of being swallowed."""
    cfg = ClassifyConfig(num_classes=4, batch_size=B, num_points=N)
    state = classify.create_state(cfg, 1)
    out = str(tmp_path / "async_ok")
    with checkpoint.AsyncSaver() as saver:
        saver.save(out, 0, state)
        saver.save(out, 1, state)
    assert checkpoint.latest_step(out) == 1
    restored = checkpoint.restore(out, classify.create_state(cfg, 1))
    assert _tree_equal(restored.params, state.params)

    saver = checkpoint.AsyncSaver()
    saver.save(str(tmp_path / "f\x00bad"), 0, state)  # invalid path
    with np.testing.assert_raises(Exception):
        saver.close()


# ---------------------------------------------------------------------------
# The .npz format: flattened leaves + key paths, checked against a template
# ---------------------------------------------------------------------------

def test_npz_layout_holds_leaves_and_paths(tmp_path):
    tree = {"a": np.arange(3, dtype=np.float32),
            "b": {"c": np.ones((2, 2), np.int32)}}
    path = checkpoint.save(str(tmp_path), 7, tree)
    with np.load(f"{path}/state.npz") as z:
        assert [str(p) for p in z["__paths__"]] == ["['a']", "['b']['c']"]
        np.testing.assert_array_equal(z["leaf_1"], tree["b"]["c"])
    back = checkpoint.restore(str(tmp_path), tree)
    assert _tree_equal(back, tree)
    assert back["b"]["c"].dtype == jnp.int32


def test_restore_rejects_treedef_mismatch(tmp_path):
    """A checkpoint of another architecture fails with a readable error
    naming the mismatched paths, not a shape error at apply time."""
    import pytest

    z = lambda n: np.zeros(n, np.float32)  # noqa: E731
    checkpoint.save(str(tmp_path), 0, {"w": z(3), "b": z(2)})
    with pytest.raises(ValueError, match="missing"):
        checkpoint.restore(str(tmp_path), {"w": z(3), "extra": z(1)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), {"w": z(4), "b": z(2)})


def test_restore_fields_ignores_other_subtrees(tmp_path):
    """Generator-only restore works when the D subtree of the checkpoint
    differs from the template's (e.g. a wider ``--d_geometry`` input)."""
    cfg = AdversarialConfig(num_parts=4, batch_size=B, num_points=N,
                            feature_transform=False, d_geometry=True)
    saved = adversarial.create_state(cfg, 1)
    checkpoint.save(str(tmp_path), 1, saved)
    template = adversarial.create_state(
        AdversarialConfig(num_parts=4, batch_size=B, num_points=N,
                          feature_transform=False), 1)
    got = checkpoint.restore_fields(str(tmp_path), template,
                                    ["g_params", "g_bn_state"])
    assert _tree_equal(got["g_params"], saved.g_params)
    assert _tree_equal(got["g_bn_state"], saved.g_bn_state)
