"""Serving-artifact exports (utils/serving.py): round-trip parity.

The reference's serving story is load-.pth-and-call
(``upstream:eval_*.py``); here the deployable unit is a serialized
``jax.export`` StableHLO artifact with the weights embedded. These tests
pin: (a) the artifact reproduces the live eval forward exactly, (b) the
symbolic batch dim serves multiple batch sizes from one artifact, (c)
the artifact survives a real serialize -> bytes -> deserialize cycle
with no model code on the loading side, and (d) the CLI drives the whole
path from an on-disk checkpoint.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds.configs import (
    ClassifyConfig, SegmentConfig,
)
from adversarial_learning_on_pointclouds.models import classifier, segmenter
from adversarial_learning_on_pointclouds.ops import use_pallas
from adversarial_learning_on_pointclouds.train import classify, segment
from adversarial_learning_on_pointclouds.utils import serving

N = 64


def _cls_state():
    cfg = ClassifyConfig(num_points=N, num_classes=7,
                         feature_transform=True)
    return classify.create_state(cfg, steps_per_epoch=1)


def test_classifier_export_round_trip(tmp_path):
    state = _cls_state()
    exp = serving.export_classifier(state.params, state.bn_state, N,
                                    platforms=("cpu",))
    path = str(tmp_path / "cls.shlo")
    serving.save_exported(exp, path)
    loaded = serving.load_exported(path)

    x = np.random.default_rng(0).standard_normal((5, N, 3)).astype(
        np.float32)
    got = np.asarray(loaded.call(x))
    assert got.shape == (5, 7)
    with use_pallas(False):
        want = np.asarray(classifier.apply_classifier(
            state.params, state.bn_state, jnp.asarray(x), train=False)[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_symbolic_batch_serves_multiple_sizes(tmp_path):
    state = _cls_state()
    exp = serving.export_classifier(state.params, state.bn_state, N,
                                    platforms=("cpu",))
    path = str(tmp_path / "cls.shlo")
    serving.save_exported(exp, path)
    loaded = serving.load_exported(path)
    for b in (1, 3, 8):
        x = np.zeros((b, N, 3), np.float32)
        assert np.asarray(loaded.call(x)).shape == (b, 7)


def test_pinned_batch_rejects_other_sizes(tmp_path):
    state = _cls_state()
    exp = serving.export_classifier(state.params, state.bn_state, N,
                                    batch=4, platforms=("cpu",))
    assert np.asarray(
        exp.call(np.zeros((4, N, 3), np.float32))).shape == (4, 7)
    with pytest.raises(Exception):
        exp.call(np.zeros((2, N, 3), np.float32))


def test_segmenter_export_round_trip(tmp_path):
    cfg = SegmentConfig(num_points=N, num_parts=9, feature_transform=True)
    state = segment.create_state(cfg, steps_per_epoch=1)
    exp = serving.export_segmenter(state.params, state.bn_state, N,
                                   platforms=("cpu",))
    path = str(tmp_path / "seg.shlo")
    serving.save_exported(exp, path)
    loaded = serving.load_exported(path)

    x = np.random.default_rng(1).standard_normal((3, N, 3)).astype(
        np.float32)
    got = np.asarray(loaded.call(x))
    assert got.shape == (3, N, 9)
    with use_pallas(False):
        want = np.asarray(segmenter.apply_segmenter(
            state.params, state.bn_state, jnp.asarray(x), train=False)[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_export_forces_xla_path_even_with_pallas_on(tmp_path):
    # The exporting process may have the kernel route enabled; the
    # artifact must still be the portable XLA lowering (a kernel's custom
    # call would pin the artifact to one backend).
    state = _cls_state()
    with use_pallas(True, interpret=True):
        exp = serving.export_classifier(state.params, state.bn_state, N,
                                        platforms=("cpu",))
    x = np.random.default_rng(2).standard_normal((2, N, 3)).astype(
        np.float32)
    got = np.asarray(exp.call(x))
    with use_pallas(False):
        want = np.asarray(classifier.apply_classifier(
            state.params, state.bn_state, jnp.asarray(x), train=False)[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_export_serving_cli(tmp_path, monkeypatch):
    # Full CLI path: train-state checkpoint on disk -> artifact ->
    # --verify (deserialize + compare vs live model) asserts internally.
    from adversarial_learning_on_pointclouds.utils import checkpoint
    from scripts import export_serving

    state = _cls_state()
    ckpt = tmp_path / "ckpt"
    checkpoint.save(str(ckpt), 0, state)
    out = tmp_path / "cls.shlo"
    monkeypatch.setattr(
        "sys.argv",
        ["export_serving.py", "--model", "cls", "--checkpoint", str(ckpt),
         "--out", str(out), "--num_points", str(N), "--num_classes", "7",
         "--feature_transform", "--platforms", "cpu", "--batch", "2",
         "--verify"])
    export_serving.main()
    assert out.exists() and out.stat().st_size > 0


def test_infer_cli_artifact_and_checkpoint(tmp_path, monkeypatch, capsys):
    # Serving artifact -> infer over a .pts shape (seg, ply out), and a
    # live checkpoint -> infer over an .h5 batch (cls).
    import h5py

    from adversarial_learning_on_pointclouds.configs import SegmentConfig
    from adversarial_learning_on_pointclouds.train import segment
    from adversarial_learning_on_pointclouds.utils import checkpoint
    from scripts import infer

    rng = np.random.default_rng(0)
    pts = tmp_path / "shape.pts"
    np.savetxt(pts, rng.standard_normal((100, 3)).astype(np.float32))

    cfg = SegmentConfig(num_points=N, num_parts=9, feature_transform=True)
    st = segment.create_state(cfg, 1)
    exp = serving.export_segmenter(st.params, st.bn_state, N,
                                   platforms=("cpu",))
    art = tmp_path / "seg.shlo"
    serving.save_exported(exp, str(art))
    ply = tmp_path / "out.ply"
    # --kind omitted on purpose: derived from the artifact's output rank.
    monkeypatch.setattr("sys.argv", [
        "infer.py", "--artifact", str(art),
        "--input", str(pts), "--ply", str(ply)])
    infer.main()
    assert "parts {" in capsys.readouterr().out and ply.exists()

    h5 = tmp_path / "clouds.h5"
    with h5py.File(h5, "w") as f:
        f.create_dataset("data", data=rng.standard_normal(
            (3, 80, 3)).astype(np.float32))
    ckpt = tmp_path / "ckpt"
    checkpoint.save(str(ckpt), 0, _cls_state())
    monkeypatch.setattr("sys.argv", [
        "infer.py", "--checkpoint", str(ckpt), "--model", "cls",
        "--input", str(h5), "--num_points", str(N), "--num_classes", "7",
        "--feature_transform", "--no_pallas"])
    infer.main()
    out = capsys.readouterr().out
    assert out.count("class") == 3


def test_infer_pinned_batch_pads_ragged_tail(tmp_path, monkeypatch, capsys):
    # A pinned-batch artifact must still serve inputs whose count is not
    # a multiple of the pin: the tail batch is zero-padded and trimmed.
    import h5py

    from scripts import infer

    state = _cls_state()
    exp = serving.export_classifier(state.params, state.bn_state, N,
                                    batch=2, platforms=("cpu",))
    art = tmp_path / "cls_b2.shlo"
    serving.save_exported(exp, str(art))
    h5 = tmp_path / "clouds.h5"
    with h5py.File(h5, "w") as f:
        f.create_dataset("data", data=np.random.default_rng(5)
                         .standard_normal((3, 80, 3)).astype(np.float32))
    monkeypatch.setattr("sys.argv", [
        "infer.py", "--artifact", str(art), "--input", str(h5)])
    infer.main()
    out = capsys.readouterr().out
    assert out.count("class") == 3  # all 3 clouds predicted, pad trimmed


def test_export_precision_is_pinned_not_ambient(tmp_path):
    # Exporting from inside a bf16 mixed-precision scope must still
    # produce the fp32-HIGHEST artifact (parity mode); bf16 artifacts
    # are an explicit opt-in and land within bf16 tolerance.
    from adversarial_learning_on_pointclouds.models.core import (
        mixed_precision,
    )

    state = _cls_state()
    x = np.random.default_rng(3).standard_normal((2, N, 3)).astype(
        np.float32)
    with use_pallas(False):
        want = np.asarray(classifier.apply_classifier(
            state.params, state.bn_state, jnp.asarray(x), train=False)[0])

    with mixed_precision():  # ambient bf16 scope, must be ignored
        exp32 = serving.export_classifier(state.params, state.bn_state, N,
                                          platforms=("cpu",))
    np.testing.assert_allclose(np.asarray(exp32.call(x)), want,
                               rtol=0, atol=1e-6)

    exp16 = serving.export_classifier(state.params, state.bn_state, N,
                                      platforms=("cpu",), bf16=True)
    got16 = np.asarray(exp16.call(x))
    assert not np.allclose(got16, want, rtol=0, atol=1e-6)  # really bf16
    np.testing.assert_allclose(got16, want, rtol=0, atol=0.15)


def test_default_export_lowers_for_cpu_and_cuda():
    """The default artifact targets the CPU and the GPU (no kernel custom
    call) and runs on the CPU it was exported from."""
    assert serving.DEFAULT_PLATFORMS == ("cpu", "cuda")
    state = _cls_state()
    exp = serving.export_classifier(state.params, state.bn_state, N)
    assert tuple(exp.platforms) == ("cpu", "cuda")
    assert "triton" not in exp.mlir_module()
    x = np.zeros((2, N, 3), np.float32)
    assert np.asarray(exp.call(x)).shape == (2, 7)
