#!/usr/bin/env python
"""Export a trained checkpoint as a self-contained StableHLO serving
artifact (``jax.export``; see ``utils/serving.py``).

The reference's deployment story is "load the .pth and call the module"
(``upstream:eval_*.py``); this is the equivalent here plus the
ahead-of-time step: the artifact embeds the weights, needs no model code
at serving time, and retargets any exported platform on load.

    export_serving.py --model cls --checkpoint cls/ --out cls.shlo
    export_serving.py --model seg --checkpoint seg/ --out seg.shlo
    export_serving.py --model adv --checkpoint adv/ --out g.shlo   # the G

Verify a fresh artifact round-trips (deserialize + call == live model):
``--verify`` runs both on a random batch and reports the max |delta|.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=("cls", "seg", "adv"), required=True,
                   help="cls: classifier; seg: segmenter; adv: the "
                        "adversarial checkpoint's generator (a segmenter)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint dir (as written by training)")
    p.add_argument("--out", type=str, required=True,
                   help="artifact path to write")
    p.add_argument("--num_points", type=int, default=0,
                   help="serving point count (0 = the trainer default: "
                        "1024 cls, 2500 seg/adv)")
    p.add_argument("--num_classes", type=int, default=40)
    p.add_argument("--num_parts", type=int, default=50)
    p.add_argument("--batch", type=int, default=0,
                   help="pin the batch dim (0 = symbolic: one artifact "
                        "serves every batch size)")
    p.add_argument("--platforms", type=str, default="cpu,cuda",
                   help="comma-separated lowering targets")
    p.add_argument("--feature_transform", action="store_true")
    p.add_argument("--verify", action="store_true",
                   help="deserialize the written artifact and compare "
                        "against the live model on a random batch")
    a = p.parse_args()

    import numpy as np

    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig, ClassifyConfig, SegmentConfig,
    )
    from adversarial_learning_on_pointclouds.train import (
        adversarial, classify, segment,
    )
    from adversarial_learning_on_pointclouds.utils import (
        checkpoint, serving,
    )

    platforms = tuple(s.strip() for s in a.platforms.split(",") if s.strip())
    batch = a.batch or None
    if a.model == "cls":
        npts = a.num_points or 1024
        cfg = ClassifyConfig(num_points=npts, num_classes=a.num_classes,
                             feature_transform=a.feature_transform)
        state = checkpoint.restore(
            a.checkpoint, classify.create_state(cfg, steps_per_epoch=1))
        params, bn = state.params, state.bn_state
        exp = serving.export_classifier(params, bn, npts, batch, platforms)
    elif a.model == "seg":
        npts = a.num_points or 2500
        cfg = SegmentConfig(num_points=npts, num_parts=a.num_parts,
                            feature_transform=a.feature_transform)
        state = checkpoint.restore(
            a.checkpoint, segment.create_state(cfg, steps_per_epoch=1))
        params, bn = state.params, state.bn_state
        exp = serving.export_segmenter(params, bn, npts, batch, platforms)
    else:
        npts = a.num_points or 2500
        cfg = AdversarialConfig(num_points=npts, num_parts=a.num_parts,
                                feature_transform=a.feature_transform)
        state = checkpoint.restore(
            a.checkpoint, adversarial.create_state(cfg, steps_per_epoch=1))
        params, bn = state.g_params, state.g_bn_state
        exp = serving.export_segmenter(params, bn, npts, batch, platforms)

    serving.save_exported(exp, a.out)
    print(f"wrote {a.out} ({os.path.getsize(a.out) / 1e6:.1f} MB, "
          f"platforms={platforms}, batch="
          f"{'symbolic' if batch is None else batch}, N={npts})")

    if a.verify:
        import jax

        from adversarial_learning_on_pointclouds.ops import use_pallas

        backend = {"gpu": "cuda"}.get(jax.default_backend(),
                                      jax.default_backend())
        if backend not in platforms:
            raise SystemExit(
                f"--verify needs a backend in {platforms} to execute the "
                f"artifact (running on {jax.default_backend()!r}); "
                "re-run the verify on matching hardware")
        loaded = serving.load_exported(a.out)
        x = np.random.default_rng(0).standard_normal(
            (batch or 4, npts, 3)).astype(np.float32)
        got = np.asarray(loaded.call(x))
        with use_pallas(False):
            if a.model == "cls":
                from adversarial_learning_on_pointclouds.models import (
                    classifier as m,
                )
                want = np.asarray(
                    m.apply_classifier(params, bn, x, train=False)[0])
            else:
                from adversarial_learning_on_pointclouds.models import (
                    segmenter as m,
                )
                want = np.asarray(
                    m.apply_segmenter(params, bn, x, train=False)[0])
        delta = float(np.max(np.abs(got - want)))
        print(f"verify: max |artifact - live| = {delta:.3e}")
        # 2e-5: both sides run the same fp32 HIGHEST XLA graph, so
        # they differ only by compilation; a real lowering bug shows up
        # orders of magnitude above this.
        if delta >= 2e-5:
            raise SystemExit(f"verify FAILED: delta {delta:.3e} >= 2e-5")


if __name__ == "__main__":
    main()
