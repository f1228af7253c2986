"""Round-4 fixes (ADVICE r3): explicit per-point trimming in
``point_sharded_eval``, sticky AsyncSaver failures, eval-mask coupling
check, generator-only adversarial restore (``--d_geometry``-safe
inference), and the ``--paired_heads``/``--no_paired_heads`` flag pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adversarial_learning_on_pointclouds import eval as eval_lib
from adversarial_learning_on_pointclouds.configs import (
    AdversarialConfig, adversarial_config_from_args,
)
from adversarial_learning_on_pointclouds.parallel import (
    make_mesh, point_sharded_eval,
)
from adversarial_learning_on_pointclouds.train import adversarial
from adversarial_learning_on_pointclouds.utils import checkpoint

B, N = 4, 64


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh()


# ---------------------------------------------------------------------------
# point_sharded_eval: explicit per_point beats the shape coincidence
# ---------------------------------------------------------------------------

def _pooled_40_apply(params, state, x, train=False):
    # A classifier-like apply whose POOLED output width (40) equals the
    # padded point count when n=35 is padded to 40 on the 8-device mesh —
    # exactly the coincidence ADVICE r3 flagged: the old shape heuristic
    # would trim 5 class logits as if they were pad points.
    pooled = jnp.max(x, axis=1)  # [B, 3]
    logits = jnp.concatenate([pooled] * 14, axis=-1)[:, :40]
    return logits, state


def test_point_sharded_eval_explicit_per_point(mesh):
    n = 35  # pads to 40 on 8 devices -> n + pad == 40 == output width
    x = np.random.default_rng(0).standard_normal((B, n, 3)).astype(
        np.float32)

    out = point_sharded_eval(_pooled_40_apply, {}, {}, x, mesh,
                             per_point=False)
    assert out.shape == (B, 40)  # class axis intact, NOT trimmed to 35

    # And per_point=True on a genuinely per-point output still trims.
    def per_point_apply(params, state, x, train=False):
        return x * 2.0, state

    outp = point_sharded_eval(per_point_apply, {}, {}, x, mesh,
                              per_point=True)
    assert outp.shape == (B, n, 3)
    np.testing.assert_allclose(np.asarray(outp), x * 2.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# Eval-order <-> host-mask coupling: the opt-in readback verification
# ---------------------------------------------------------------------------

def test_eval_mask_coupling_check(monkeypatch):
    from adversarial_learning_on_pointclouds.models import (
        init_classifier,
    )

    monkeypatch.setenv("POINTTPU_CHECK_EVAL_MASKS", "1")
    rng = np.random.default_rng(3)
    n, bs = 21, 8  # ragged tail -> pad+mask on the final batch
    x = rng.standard_normal((n, N, 3)).astype(np.float32)
    y = rng.integers(0, 5, n).astype(np.int32)
    cp, cs = init_classifier(jax.random.PRNGKey(0), 5)
    res = eval_lib.evaluate_classifier(cp, cs, x, y, bs, 5)
    assert res["num_examples"] == float(n)


# ---------------------------------------------------------------------------
# Generator-only restore: --d_geometry checkpoints infer without the flag
# ---------------------------------------------------------------------------

def test_restore_fields_generator_subtree_d_geometry(tmp_path):
    cfg_geo = AdversarialConfig(num_points=N, num_parts=9, batch_size=B,
                                feature_transform=True, d_geometry=True)
    st_geo = adversarial.create_state(cfg_geo, 1)
    ckpt = str(tmp_path / "adv_geo")
    checkpoint.save(ckpt, 0, st_geo)

    # Template WITHOUT d_geometry: D input is narrower, so a full-state
    # restore cannot match — but inference needs only the G subtree.
    cfg = AdversarialConfig(num_points=N, num_parts=9, batch_size=B,
                            feature_transform=True)
    tmpl = adversarial.create_state(cfg, 1)
    sub = checkpoint.restore_fields(ckpt, tmpl, ("g_params", "g_bn_state"))
    for a, b in zip(jax.tree_util.tree_leaves(sub["g_params"]),
                    jax.tree_util.tree_leaves(st_geo.g_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_infer_cli_adv_d_geometry_checkpoint(tmp_path, monkeypatch, capsys):
    # The user-facing repro from ADVICE r3: `infer.py --model adv` on a
    # checkpoint trained with --d_geometry must not fail on the wider D.
    import h5py

    from scripts import infer

    cfg = AdversarialConfig(num_points=N, num_parts=9, batch_size=B,
                            feature_transform=True, d_geometry=True)
    st = adversarial.create_state(cfg, 1)
    ckpt = tmp_path / "ckpt_adv_geo"
    checkpoint.save(str(ckpt), 0, st)

    h5 = tmp_path / "clouds.h5"
    with h5py.File(h5, "w") as f:
        f.create_dataset("data", data=np.random.default_rng(5)
                         .standard_normal((2, 80, 3)).astype(np.float32))
    monkeypatch.setattr("sys.argv", [
        "infer.py", "--checkpoint", str(ckpt), "--model", "adv",
        "--input", str(h5), "--num_points", str(N), "--num_parts", "9",
        "--feature_transform", "--no_pallas"])
    infer.main()
    out = capsys.readouterr().out
    assert out.count("parts {") == 2


# ---------------------------------------------------------------------------
# --paired_heads / --no_paired_heads: shared dest, neither flag dead
# ---------------------------------------------------------------------------

def test_paired_heads_flag_pair():
    base = ["--dataset", "x"]
    assert adversarial_config_from_args(base).paired_heads is True
    assert adversarial_config_from_args(
        base + ["--paired_heads"]).paired_heads is True
    assert adversarial_config_from_args(
        base + ["--no_paired_heads"]).paired_heads is False
    # Both passed: argparse last-wins (predictable, not silently paired).
    assert adversarial_config_from_args(
        base + ["--paired_heads", "--no_paired_heads"]).paired_heads is False
    assert adversarial_config_from_args(
        base + ["--no_paired_heads", "--paired_heads"]).paired_heads is True


# ---------------------------------------------------------------------------
# AsyncSaver sticky error is pinned in test_round3 (close() re-raises);
# here: the success path must NOT trip the sticky check.
# ---------------------------------------------------------------------------

def test_async_saver_clean_close_no_sticky(tmp_path):
    with checkpoint.AsyncSaver() as saver:
        saver.save(str(tmp_path / "ok"), 0, {"w": np.ones(3)})
    assert checkpoint.latest_step(str(tmp_path / "ok")) == 0


# ---------------------------------------------------------------------------
# AsyncSaver 'best' policy: model selection via metric-gated saves
# ---------------------------------------------------------------------------

def test_async_saver_best_policy(tmp_path, monkeypatch):
    """'best' saves only metric-improving epochs, so latest_step() (what
    restore(step=None) resolves) is the best-metric epoch; a metric-less
    save stays unconditional (explicit final saves)."""
    written = []
    monkeypatch.setattr(checkpoint, "save",
                        lambda d, step, state: written.append(step))
    mious = [0.10, 0.30, 0.20, 0.45, 0.45, 0.40]  # best at epoch 3
    with checkpoint.AsyncSaver(policy="best") as saver:
        for epoch, m in enumerate(mious):
            saver.save(str(tmp_path), epoch, {"w": epoch}, metric=m)
    assert written == [0, 1, 3], written  # improvements only; ties skip

    written.clear()
    with checkpoint.AsyncSaver(policy="best") as saver:
        saver.save(str(tmp_path), 0, {"w": 0}, metric=0.9)
        saver.save(str(tmp_path), 1, {"w": 1}, metric=0.1)  # worse: skip
        saver.save(str(tmp_path), 2, {"w": 2})  # no metric: unconditional
    assert written == [0, 2], written


def test_async_saver_best_restore_latest_is_best(tmp_path):
    """End-to-end through real checkpoint writes: under 'best', the newest
    checkpoint dir is the best epoch and restore(step=None) loads it."""
    d = str(tmp_path / "best")
    with checkpoint.AsyncSaver(policy="best") as saver:
        for epoch, m in enumerate([0.2, 0.6, 0.3]):
            saver.save(d, epoch, {"w": np.full(3, float(epoch))}, metric=m)
    assert checkpoint.latest_step(d) == 1
    got = checkpoint.restore(d, {"w": jnp.zeros(3)})
    np.testing.assert_allclose(np.asarray(got["w"]), 1.0)


def test_ckpt_policy_best_cli():
    cfg = adversarial_config_from_args(["--ckpt_policy", "best"])
    assert cfg.ckpt_policy == "best"


# ---------------------------------------------------------------------------
# --eval_every K: cadence for eval-dominated runs (sweeps: eval_s ~ 60x
# train_s on the CPU cluster cells)
# ---------------------------------------------------------------------------

def test_eval_every_cadence_and_best_policy(tmp_path, monkeypatch):
    """K=2 over 5 epochs evaluates at epochs 1, 3 and the final 4;
    'every' still checkpoints every epoch, 'best' saves only measured
    (eval) epochs."""
    import os

    from adversarial_learning_on_pointclouds.configs import (
        ClassifyConfig,
    )
    from adversarial_learning_on_pointclouds.train import runner

    evals = []
    real = eval_lib.evaluate_classifier_device

    def counting(*args, **kw):
        evals.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(runner.eval_lib, "evaluate_classifier_device",
                        counting)
    base = dict(batch_size=4, num_points=64, epochs=5, num_classes=4,
                quiet=True, num_devices=1, seed=1, eval_every=2)
    runner.run_classification(ClassifyConfig(
        out_dir=str(tmp_path / "ee"), ckpt_policy="every", **base))
    assert len(evals) == 3
    assert sorted(int(d) for d in os.listdir(str(tmp_path / "ee"))
                  if d.isdigit()) == [0, 1, 2, 3, 4]

    evals.clear()
    runner.run_classification(ClassifyConfig(
        out_dir=str(tmp_path / "best"), ckpt_policy="best", **base))
    assert len(evals) == 3
    saved = {int(d) for d in os.listdir(str(tmp_path / "best"))
             if d.isdigit()}
    assert saved and saved <= {1, 3, 4}, saved  # only measured epochs


def test_eval_every_rejects_fused_epoch():
    from adversarial_learning_on_pointclouds.train import runner

    cfg = AdversarialConfig(fused_epoch=True, eval_every=2, batch_size=4,
                            num_points=64, epochs=1)
    with pytest.raises(ValueError, match="eval_every"):
        runner.run_adversarial(cfg)


def test_eval_every_cli():
    cfg = adversarial_config_from_args(["--eval_every", "4"])
    assert cfg.eval_every == 4
    assert adversarial_config_from_args([]).eval_every == 1


# ---------------------------------------------------------------------------
# Ablation sweep resume: completed cells are never re-run after a crash
# ---------------------------------------------------------------------------

def test_ablation_sweep_resumes_from_partial(tmp_path, monkeypatch):
    import json

    from adversarial_learning_on_pointclouds.train import runner
    from scripts import ablation_adversarial_gain as abl

    calls = []

    def fake_run(cfg):
        calls.append((cfg.labeled_ratio, cfg.seed, cfg.supervised_only))
        if len(calls) == 3 and not getattr(fake_run, "resumed", False):
            raise KeyboardInterrupt("simulated wedge")  # cell 3 dies
        return {"best_miou": 0.5 + 0.01 * len(calls)}

    monkeypatch.setattr(runner, "run_adversarial", fake_run)
    out = str(tmp_path / "abl.json")
    argv = ["x", "--seeds", "2", "--ratios", "0.5", "--modes", "sup",
            "adv", "--dataset", "unused", "--json", out]
    monkeypatch.setattr("sys.argv", argv)
    with pytest.raises(KeyboardInterrupt):
        abl.main()
    assert not (tmp_path / "abl.json").exists()
    # Two completed cells landed in the sidecar before the crash.
    part = out + ".partial"
    with open(part) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert len(lines) == 1 + 2  # header + 2 cells

    fake_run.resumed = True
    calls.clear()
    monkeypatch.setattr("sys.argv", argv)
    abl.main()
    # Only the 2 remaining cells ran; artifact complete, sidecar gone.
    assert len(calls) == 2
    with open(out) as f:
        art = json.load(f)
    assert len(art["runs"]) == 4
    assert not (tmp_path / "abl.json.partial").exists()

    # A partial from a DIFFERENT sweep config is ignored, not consumed.
    with open(part, "w") as f:
        f.write(json.dumps({"config_fp": "other"}) + "\n")
    calls.clear()
    monkeypatch.setattr("sys.argv", argv)
    abl.main()
    assert len(calls) == 4  # full sweep re-ran


def test_ablation_seed_base_extension_and_pooled_digest(
        tmp_path, monkeypatch, capsys):
    """--seed_base runs seeds [base, base+seeds) so a follow-on sweep
    EXTENDS an earlier artifact's N; ablation_digest --merge pools both
    artifacts into one seed-paired table."""
    import json

    from adversarial_learning_on_pointclouds.train import runner
    from scripts import ablation_adversarial_gain as abl
    from scripts import ablation_digest as dig

    def fake_run(cfg):
        # Deterministic per-cell value; adv beats sup by 0.02 always.
        return {"best_miou": 0.5 + 0.001 * cfg.seed
                + (0.02 if not cfg.supervised_only else 0.0)}

    monkeypatch.setattr(runner, "run_adversarial", fake_run)
    outs = []
    for base in (0, 2):
        out = str(tmp_path / f"abl_{base}.json")
        outs.append(out)
        monkeypatch.setattr("sys.argv", [
            "x", "--seeds", "2", "--seed_base", str(base), "--ratios",
            "0.5", "--modes", "sup", "adv", "--dataset", "unused",
            "--json", out])
        abl.main()
    with open(outs[1]) as f:
        art = json.load(f)
    assert sorted({r["seed"] for r in art["runs"]}) == [2, 3]

    capsys.readouterr()
    monkeypatch.setattr("sys.argv", ["x", "--merge"] + outs)
    dig.main()
    tbl = capsys.readouterr().out
    assert "seeds [0, 1, 2, 3]" in tbl
    # 4/4 positive seeds -> exact two-sided sign test p = 2/2^4 = 0.125.
    assert "+0.0200" in tbl and "(4/4+, p=0.12)" in tbl


# ---------------------------------------------------------------------------
# Point-sharded TRAINING (giant-cloud train step over the mesh)
# ---------------------------------------------------------------------------

def test_point_sharded_train_step_matches_replicated(mesh):
    """One segmenter train step with the POINT axis sharded over 8
    devices == the single-device step: loss tight, BN running stats at
    the fp reduction floor (post-Adam params are NOT compared — step-1
    normalization amplifies near-zero-grad noise to ±lr)."""
    from adversarial_learning_on_pointclouds.configs import (
        SegmentConfig,
    )
    from adversarial_learning_on_pointclouds.parallel import (
        point_sharded_train_step,
    )
    from adversarial_learning_on_pointclouds.train import segment

    # Batch 8, not 2: the fc-head BNs reduce over the batch axis, and
    # 2-sample batch statistics amplify fp reduction-order noise hugely
    # (measured: rel 5.6e-4 at B=2 vs 3.6e-7 at B=8 — CLAUDE.md
    # numerics note; the 1e-5 bound below is ~28x the B=8 floor).
    n = 8 * N
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, n, 3)).astype(np.float32)
    y = rng.integers(0, 6, (8, n)).astype(np.int32)
    cfg = SegmentConfig(num_parts=6, num_points=n, batch_size=8,
                        feature_transform=True, augment=False)
    tx = segment.make_tx(cfg, 1)
    state = segment.create_state(cfg, 1)

    # Reference on the SAME forced-XLA path the sharded step uses (the
    # fused-kernel path differs at fp-reassociation level, which the
    # batch-2 head BNs amplify — CLAUDE.md numerics note); remaining
    # delta is GSPMD partial-reduction order only.
    from adversarial_learning_on_pointclouds.ops import dispatch

    paths = (False, False, dispatch.current_paths()[2])
    ref_state, ref_m = segment._train_step(
        state, jnp.asarray(x), jnp.asarray(y), cfg=cfg, tx=tx,
        paths=paths)
    sh_state, sh_m = point_sharded_train_step(
        state, x, y, mesh, cfg=cfg, tx=tx)
    assert float(sh_m["loss"]) == pytest.approx(float(ref_m["loss"]),
                                                rel=1e-5)
    # BN running stats see the same batch statistics up to the GSPMD
    # partial-reduction order.
    for a, b in zip(jax.tree_util.tree_leaves(sh_state.bn_state),
                    jax.tree_util.tree_leaves(ref_state.bn_state)):
        scale = 1.0 + float(jnp.max(jnp.abs(b)))
        assert float(jnp.max(jnp.abs(a - b))) <= 1e-4 * scale

    # Indivisible N is rejected loudly (padding would bias BN stats).
    with pytest.raises(ValueError):
        point_sharded_train_step(state, x[:, :n - 3], y[:, :n - 3],
                                 mesh, cfg=cfg, tx=tx)


# ---------------------------------------------------------------------------
# Giant-cloud trainer CLI (point-sharded training end-to-end)
# ---------------------------------------------------------------------------

def test_train_giant_cloud_script(tmp_path, monkeypatch):
    """scripts/train_giant_cloud.py drives point_sharded_train_step +
    point_sharded_eval end-to-end on the 8-device mesh: runs, logs
    finite metrics, writes a restorable checkpoint. (No --cpu flag: the
    conftest already forced the 8-device CPU backend; the flag exists
    for standalone runs before first device use.)"""
    from scripts import train_giant_cloud

    out = str(tmp_path / "giant")
    monkeypatch.setattr("sys.argv", [
        "x", "--num_points", "512", "--num_shapes", "8", "--batchSize",
        "2", "--nepoch", "1", "--outf", out])
    best = train_giant_cloud.main()
    assert np.isfinite(best) and 0.0 <= best <= 1.0
    from adversarial_learning_on_pointclouds.utils import checkpoint
    assert checkpoint.latest_step(out) == 0


# ---------------------------------------------------------------------------
# Packaging (pyproject.toml)
# ---------------------------------------------------------------------------

def test_package_version_matches_pyproject():
    """pyproject.toml [project].version and the package __version__ must
    stay in sync (the wheel metadata is built from pyproject)."""
    import os
    import tomllib

    import adversarial_learning_on_pointclouds as pkg

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        meta = tomllib.load(f)["project"]
    assert meta["version"] == pkg.__version__
    # The native C++ source must be declared as package data, or an
    # installed wheel silently loses the fast .pts loader.
    assert os.path.exists(os.path.join(
        root, "adversarial_learning_on_pointclouds", "native",
        "pts_loader.cpp"))
