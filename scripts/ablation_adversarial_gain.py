#!/usr/bin/env python
"""Adversarial-gain ablation: config-4 (adv + semi) vs supervised-only on
the SAME labeled subset (VERDICT round 2, next #1).

The reference's reason to exist is Hung et al.'s claim (arXiv:1802.07934,
SURVEY.md §6) that adversarial + semi-supervised training improves mIoU
when only a fraction of the training set is labeled (+1-3 mIoU at 1/2
labels on real data). This script measures that delta end-to-end through
the REAL runner on the synthetic ShapeNet fixture: for each labeled_ratio
and seed it trains (a) the full adversarial+semi config and (b) the
``--supervised_only`` control — identical labeled split, identical data
pipeline, identical G architecture/optimizer — and reports best-epoch
instance mIoU per run plus per-ratio mean +- std and the adv-sup delta.

Results land in a JSON artifact (one dict; see ``--json``) and a
markdown table on stdout (narrative in docs/ADVERSARIAL_GAIN.md).

Usage (the round-3 table's setting):
    python scripts/ablation_adversarial_gain.py \
        --seeds 3 --ratios 0.25 0.5 --nepoch 100 --num_shapes 512
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=3, help="seeds per cell")
    p.add_argument("--seed_base", type=int, default=0,
                   help="first seed (cells run seeds seed_base..+seeds); "
                        "lets a follow-on sweep EXTEND an earlier "
                        "artifact's N without re-running its seeds — "
                        "pool with ablation_digest.py --merge a.json "
                        "b.json (without --merge you get side-by-side "
                        "small-N tables, not the seed union)")
    p.add_argument("--ratios", type=float, nargs="+", default=[0.25, 0.5])
    p.add_argument("--nepoch", type=int, default=100)
    p.add_argument("--batchSize", type=int, default=16)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--num_shapes", type=int, default=512,
                   help="synthetic fixture size (384 train / 64 test)")
    p.add_argument("--scan", type=int, default=0,
                   help="K-step fused launches; 0 default — the sweep's "
                        "6-12 steps/epoch rarely fill a K=8 group, so "
                        "scan only adds compile variants here")
    p.add_argument("--eval_every", type=int, default=1,
                   help="eval every K-th epoch + the final one (cells "
                        "are eval-dominated: ~60x train_s on CPU; "
                        "best_miou then selects over the evaluated "
                        "epochs only — a PROTOCOL change, keep it "
                        "uniform across artifacts you pool)")
    p.add_argument("--semi_start", type=int, default=0)
    p.add_argument("--lambda_semi", type=float, default=0.1)
    p.add_argument("--lambda_adv", type=float, default=0.01)
    p.add_argument("--lambda_adv_unl", type=float, default=None)
    p.add_argument("--threshold", type=float, default=0.2)
    p.add_argument("--st_threshold", type=float, default=None,
                   help="confidence cut for the 'st' cells only "
                        "(default: --threshold). The D threshold and "
                        "the max-softmax confidence live on different "
                        "scales, so a fair self-training baseline may "
                        "need its own sweep.")
    p.add_argument("--d_geometry", action="store_true",
                   help="run the adv cells with the geometry-aware D "
                        "extension (xyz channels on the D input)")
    p.add_argument("--modes", type=str, nargs="+",
                   default=["sup", "adv"],
                   choices=["sup", "adv", "geo", "st"],
                   help="paired cells per (ratio, seed): sup = "
                        "--supervised_only control, adv = config-4 "
                        "adv+semi, geo = adv+semi with --d_geometry, "
                        "st = D-free --self_training (pseudo-label "
                        "mask from G's own confidence)")
    p.add_argument("--boundary_jitter", type=float, default=0.0,
                   help="per-shape label-boundary jitter for the "
                        "generated fixture (fraction of a part width; "
                        "irreducible-noise control regime — the offset "
                        "is independent of the geometry, so no method "
                        "can recover it)")
    p.add_argument("--cluster_sigma", type=float, default=0.18,
                   help="blob std-dev for the --cluster_parts fixture "
                        "(vs ~1.1 inter-anchor distance). Larger = more "
                        "blob overlap = more boundary points whose label "
                        "is ambiguous given position — the round-5 "
                        "fixture rung probing whether boundary ambiguity "
                        "opens a gain regime for the label-map prior")
    p.add_argument("--cluster_parts", action="store_true",
                   help="cluster-assumption fixture: parts ARE "
                        "per-shape-jittered Gaussian blobs, so part "
                        "boundaries lie in density valleys and "
                        "unlabeled clouds carry the structure the "
                        "semi/adversarial losses exploit")
    p.add_argument("--dataset", type=str, default="",
                   help="fixture root ('' = build a dedicated synthetic "
                        "fixture of --num_shapes shapes)")
    p.add_argument("--json", type=str, default="ABLATION_r03.json")
    p.add_argument("--quick", action="store_true",
                   help="tiny smoke setting (CI): 1 seed, 2 epochs, "
                        "96 shapes")
    a = p.parse_args()
    if a.quick:
        a.seeds, a.nepoch, a.num_shapes = 1, 2, 96
        a.ratios = [0.5]

    import numpy as np

    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.data.shapenet_part import (
        make_synthetic_shapenet,
    )
    from adversarial_learning_on_pointclouds.train import runner

    root = a.dataset
    if not root:
        # Keyed on shapes AND points (and jitter, when set) — the
        # listdir guard below would otherwise reuse a fixture generated
        # at different parameters.
        tag = (f"pointtpu_ablation_shapenet_{a.num_shapes}x{a.num_points}"
               + (f"_bj{a.boundary_jitter:g}" if a.boundary_jitter else "")
               + ("_cl" if a.cluster_parts else "")
               + (f"_cs{a.cluster_sigma:g}"
                  if a.cluster_parts and a.cluster_sigma != 0.18 else ""))
        root = os.path.join(tempfile.gettempdir(), tag)
        if not (os.path.isdir(root) and os.listdir(root)):
            make_synthetic_shapenet(root, num_shapes=a.num_shapes,
                                    num_points=a.num_points,
                                    boundary_jitter=a.boundary_jitter,
                                    cluster_parts=a.cluster_parts,
                                    cluster_sigma=a.cluster_sigma)

    # Crash/wedge resume: every completed cell lands immediately in a
    # JSON-lines sidecar next to --json; a re-run with the IDENTICAL
    # sweep config (fingerprint in the header line) skips finished cells
    # instead of repaying hours of chip time. Each run is individually
    # deterministic (pinned by the determinism tests), so a resumed
    # sweep equals an uninterrupted one. The sidecar is deleted once the
    # final artifact is written.
    cfg_keys = ("seeds", "seed_base", "ratios", "nepoch", "batchSize",
                "num_points",
                "num_shapes", "scan", "semi_start", "eval_every",
                "lambda_semi",
                "lambda_adv", "lambda_adv_unl", "threshold",
                "st_threshold", "d_geometry", "modes", "boundary_jitter",
                "cluster_parts", "cluster_sigma")
    cfg_dict = {k: getattr(a, k) for k in cfg_keys}
    cfg_fp = json.dumps(cfg_dict, sort_keys=True)
    # Sidecars written before a key existed must stay resumable when the
    # key sits at its default (the sweep is identical to one recorded
    # without it; declaring the sidecar stale would truncate it and
    # silently re-pay hours of completed cells). Strip newest-added keys
    # first so every historical schema's fingerprint is generated.
    ok_fps = {cfg_fp}
    legacy = dict(cfg_dict)
    for key, default in (("cluster_sigma", 0.18), ("eval_every", 1),
                         ("seed_base", 0)):
        if legacy.get(key) != default:
            break
        del legacy[key]
        ok_fps.add(json.dumps(legacy, sort_keys=True))
    part_path = a.json + ".partial"
    done = {}
    if os.path.exists(part_path):
        with open(part_path) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        if lines and lines[0].get("config_fp") in ok_fps:
            done = {(r["ratio"], r["seed"], r["mode"]): r
                    for r in lines[1:]}
            print(f"[ablation] resuming {a.json}: {len(done)} cells "
                  f"already complete", flush=True)
        else:
            print(f"[ablation] stale partial {part_path} (different "
                  f"sweep config) — starting fresh", flush=True)
    part = open(part_path, "a" if done else "w")
    if not done:
        part.write(json.dumps({"config_fp": cfg_fp}) + "\n")
        part.flush()

    runs = []
    for ratio in a.ratios:
        for seed in range(a.seed_base, a.seed_base + a.seeds):
            for mode in a.modes:
                key = (ratio, seed, mode)
                if key in done:
                    runs.append(done[key])
                    continue
                cfg = AdversarialConfig(
                    dataset=root, labeled_ratio=ratio, seed=seed,
                    supervised_only=(mode == "sup"),
                    self_training=(mode == "st"),
                    batch_size=a.batchSize, num_points=a.num_points,
                    epochs=a.nepoch, scan=a.scan,
                    semi_start=a.semi_start, eval_every=a.eval_every,
                    lambda_semi=a.lambda_semi, lambda_adv=a.lambda_adv,
                    lambda_adv_unl=a.lambda_adv_unl,
                    semi_threshold=(a.st_threshold
                                    if mode == "st"
                                    and a.st_threshold is not None
                                    else a.threshold),
                    d_geometry=(mode == "geo"
                                or (mode == "adv" and a.d_geometry)),
                    ckpt_policy="none", quiet=True,
                    out_dir=os.path.join(tempfile.gettempdir(),
                                         f"abl_{ratio}_{seed}_{mode}"))
                t0 = time.perf_counter()
                res = runner.run_adversarial(cfg)
                dt = time.perf_counter() - t0
                row = {"ratio": ratio, "seed": seed, "mode": mode,
                       "best_miou": round(float(res["best_miou"]), 5),
                       "wall_s": round(dt, 1)}
                runs.append(row)
                part.write(json.dumps(row) + "\n")
                part.flush()
                print(f"[ablation] {row}", flush=True)
    part.close()

    summary = {}
    for ratio in a.ratios:
        cell = {}
        for mode in a.modes:
            vals = [r["best_miou"] for r in runs
                    if r["ratio"] == ratio and r["mode"] == mode]
            cell[mode] = {"mean": round(float(np.mean(vals)), 5),
                          "std": round(float(np.std(vals)), 5),
                          "runs": vals}
        # Paired per-seed deltas vs the first mode (the control): the
        # 3-seed unpaired snapshots manufactured fake deltas twice this
        # round — paired mean ± SE and the sign pattern are the numbers
        # the analysis actually needs.
        base = a.modes[0]
        for mode in a.modes[1:]:
            d = [x - y for x, y in zip(cell[mode]["runs"],
                                       cell[base]["runs"])]
            cell[f"{mode}-{base}"] = {
                "paired_mean": round(float(np.mean(d)), 5),
                "paired_se": round(float(np.std(d) / max(len(d) - 1, 1)
                                         ** 0.5), 5),
                "positive_seeds": int(sum(x > 0 for x in d)),
                "n": len(d)}
        summary[str(ratio)] = cell

    out = {"config": cfg_dict, "runs": runs, "summary": summary}
    with open(a.json, "w") as f:
        json.dump(out, f, indent=1)
    if os.path.exists(part_path):
        os.remove(part_path)
    print(f"\nwrote {a.json}")
    head = " | ".join(f"{m} mIoU" for m in a.modes)
    print(f"\n| labeled_ratio | {head} | paired deltas |")
    print("|---" * (len(a.modes) + 2) + "|")
    for ratio in a.ratios:
        c = summary[str(ratio)]
        cols = " | ".join(f"{c[m]['mean']:.4f} ± {c[m]['std']:.4f}"
                          for m in a.modes)
        ds = "; ".join(
            f"{k}: {v['paired_mean']:+.4f} ± {v['paired_se']:.4f} "
            f"({v['positive_seeds']}/{v['n']}+)"
            for k, v in c.items() if "-" in k)
        print(f"| {ratio} | {cols} | {ds} |")


if __name__ == "__main__":
    main()
