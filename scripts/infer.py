#!/usr/bin/env python
"""Run inference over a point-cloud file — the reference's
``show_cls``/``show_seg`` loop as a batch CLI (SURVEY.md §3.5), fed by
either a live checkpoint or a serialized serving artifact
(``scripts/export_serving.py``).

Inputs: a ModelNet-style ``.h5`` (``data`` dataset, [S, N, 3]), a
ShapeNet-style ``.pts`` (whitespace xyz rows, one shape), or an ascii
``.ply`` written by ``utils/ply.py``. Clouds are unit-sphere normalized
and resampled to the model's point count (the training-side contract;
``data/augment.py``) on the host.

    infer.py --artifact g.shlo --kind seg --input shape.pts --ply out.ply
    infer.py --checkpoint cls/ --model cls --input test.h5
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_clouds(path: str) -> np.ndarray:
    """-> [S, ?, 3] float32 (list of shapes; h5 may hold many)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".h5", ".hdf5"):
        import h5py
        with h5py.File(path, "r") as f:
            return np.asarray(f["data"][:], np.float32)
    if ext == ".ply":
        from adversarial_learning_on_pointclouds.utils.ply import read_ply
        return read_ply(path)[None]
    return np.loadtxt(path, dtype=np.float32).reshape(1, -1, 3)


def _prep(clouds: np.ndarray, num_points: int, seed: int = 0) -> np.ndarray:
    """Unit-sphere normalize + resample each cloud to ``num_points`` —
    the training-side eval contract (``augment.normalize_unit_sphere_np``
    math, reference ``dataset.py::__getitem__`` resample)."""
    from adversarial_learning_on_pointclouds.data.augment import (
        normalize_unit_sphere_np,
    )
    rng = np.random.default_rng(seed)
    out = np.empty((len(clouds), num_points, 3), np.float32)
    for i, pts in enumerate(clouds):
        # replace=True unconditionally — the reference's np.random.choice
        # contract (data/augment.py, native_loader.py do the same).
        idx = rng.choice(len(pts), num_points, replace=True)
        out[i] = normalize_unit_sphere_np(pts)[idx]
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--input", type=str, required=True,
                   help=".h5 ([S,N,3] 'data'), .pts (one shape), or .ply")
    p.add_argument("--artifact", type=str, default="",
                   help="serving artifact from export_serving.py")
    p.add_argument("--kind", choices=("cls", "seg"), default="",
                   help="artifact output kind; default: derived from the "
                        "artifact's output rank (cls: [B,k]; seg: [B,N,k])")
    p.add_argument("--checkpoint", type=str, default="",
                   help="live checkpoint dir, or a reference-format "
                        ".pth state_dict (alternative to --artifact)")
    p.add_argument("--model", choices=("cls", "seg", "adv"), default="cls")
    p.add_argument("--num_points", type=int, default=0,
                   help="0 = infer from the artifact / trainer default")
    p.add_argument("--num_classes", type=int, default=40)
    p.add_argument("--num_parts", type=int, default=50)
    p.add_argument("--feature_transform", action="store_true")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--ply", type=str, default="",
                   help="write the FIRST cloud's part labels as a "
                        "colored .ply (segmentation only)")
    p.add_argument("--no_pallas", action="store_true")
    a = p.parse_args()
    if not a.artifact and not a.checkpoint:
        p.error("need --artifact or --checkpoint")

    pinned_b = None
    if a.artifact:
        from adversarial_learning_on_pointclouds.utils import serving
        exp = serving.load_exported(a.artifact)
        art_n = exp.in_avals[0].shape[1]
        if a.num_points and a.num_points != art_n:
            # The exported program's point count is static; resampling
            # to a different N would fail deep inside call_exported with
            # an opaque shape error.
            p.error(f"--num_points {a.num_points} does not match the "
                    f"artifact's exported point count {art_n} "
                    "(drop --num_points, or re-export at the desired N)")
        npts = art_n
        b0 = exp.in_avals[0].shape[0]
        if isinstance(b0, int):  # pinned-batch artifact: feed exactly b0
            pinned_b = b0
        fwd = exp.call
        # The artifact self-describes its kind: [b, k] logits are the
        # classifier, [b, N, k] the segmenter.
        kind = a.kind or ("seg" if len(exp.out_avals[0].shape) == 3
                          else "cls")
    else:
        from adversarial_learning_on_pointclouds.configs import (
            AdversarialConfig, ClassifyConfig, SegmentConfig,
        )
        from adversarial_learning_on_pointclouds.ops import use_pallas
        from adversarial_learning_on_pointclouds.train import (
            adversarial, classify, segment,
        )
        from adversarial_learning_on_pointclouds.utils import checkpoint
        kind = "cls" if a.model == "cls" else "seg"
        npts = a.num_points or (1024 if kind == "cls" else 2500)
        is_pth = a.checkpoint.endswith(".pth")
        if a.model == "cls":
            from adversarial_learning_on_pointclouds.models.classifier \
                import apply_classifier as apply
            cfg = ClassifyConfig(num_points=npts, num_classes=a.num_classes,
                                 feature_transform=a.feature_transform)
            tmpl = classify.create_state(cfg, 1)
            st = (checkpoint.load_pth_warm_start(a.checkpoint, tmpl)
                  if is_pth else checkpoint.restore(a.checkpoint, tmpl))
            params, bn = st.params, st.bn_state
        else:
            from adversarial_learning_on_pointclouds.models.segmenter \
                import apply_segmenter as apply
            if a.model == "seg":
                cfg = SegmentConfig(num_points=npts, num_parts=a.num_parts,
                                    feature_transform=a.feature_transform)
                tmpl = segment.create_state(cfg, 1)
                st = (checkpoint.load_pth_warm_start(a.checkpoint, tmpl)
                      if is_pth else checkpoint.restore(a.checkpoint, tmpl))
                params, bn = st.params, st.bn_state
            else:
                cfg = AdversarialConfig(num_points=npts,
                                        num_parts=a.num_parts,
                                        feature_transform=a.feature_transform)
                if is_pth:
                    # G weights only — a reference adversarial run saves
                    # G and D as separate .pth files and inference never
                    # touches D (so a --d_geometry companion can't block
                    # the load, same rationale as the checkpoint branch); the
                    # generator trees ARE template-checked.
                    params, bn = checkpoint.load_pth_generator(
                        a.checkpoint, adversarial.create_state(cfg, 1))
                else:
                    # Generator subtree only: a full-state restore would
                    # also force the D template to match, which fails for
                    # --d_geometry checkpoints (wider D input) although
                    # inference never touches D (ADVICE r3).
                    sub = checkpoint.restore_fields(
                        a.checkpoint, adversarial.create_state(cfg, 1),
                        ("g_params", "g_bn_state"))
                    params, bn = sub["g_params"], sub["g_bn_state"]
        import jax

        from adversarial_learning_on_pointclouds.ops import dispatch

        paths = None
        with use_pallas(not a.no_pallas):
            paths = dispatch.current_paths()

        @jax.jit
        def fwd(x):
            with dispatch.path_context(paths):
                return apply(params, bn, x, train=False)[0]

    clouds = _prep(_load_clouds(a.input), npts)
    step_b = pinned_b or a.batch
    preds = []
    for s in range(0, len(clouds), step_b):
        chunk = clouds[s:s + step_b]
        n_real = len(chunk)
        if pinned_b and n_real < pinned_b:  # pad the ragged tail batch
            chunk = np.concatenate(
                [chunk, np.zeros((pinned_b - n_real, npts, 3),
                                 np.float32)], axis=0)
        logp = np.asarray(fwd(chunk))
        preds.append(np.argmax(logp, -1)[:n_real])
    pred = np.concatenate(preds, axis=0)

    if kind == "cls":
        for i, c in enumerate(pred):
            print(f"cloud {i}: class {int(c)}")
    else:
        for i, lab in enumerate(pred):
            uniq, cnt = np.unique(lab, return_counts=True)
            top = ", ".join(f"{int(u)}×{int(c)}" for u, c in
                            zip(uniq[np.argsort(-cnt)][:4],
                                np.sort(cnt)[::-1][:4]))
            print(f"cloud {i}: parts {{{top}}}")
        if a.ply:
            from adversarial_learning_on_pointclouds.utils.ply import (
                write_ply_with_labels,
            )
            write_ply_with_labels(a.ply, clouds[0], pred[0])
            print(f"wrote {a.ply}")


if __name__ == "__main__":
    main()
