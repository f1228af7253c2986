#!/usr/bin/env python
"""bf16-vs-fp32 accuracy delta on the flagship config (VERDICT r2 weak #7).

The bench headline rides bf16 mixed precision (fp32 accumulation/BN/
reductions, bf16 matmul operands) while the strict torch-parity numerics are
fp32 HIGHEST; the round-2 verdict asks that any accuracy-parity claim
state its precision mode and quantify the delta. Real datasets are not in
this environment, so this measures the delta end-to-end on the learnable
synthetic ShapeNet fixture (per-category blob constellations — the same
protocol as the adversarial-gain ablation): config-4 adv+semi at
labeled_ratio 0.5, N seeds, bf16 vs fp32, best-epoch instance mIoU on the
held-out split through the REAL runner.

Usage:
    python scripts/precision_delta.py --seeds 3 --nepoch 100
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
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--ratio", type=float, default=0.5)
    p.add_argument("--nepoch", type=int, default=100)
    p.add_argument("--batchSize", type=int, default=16)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--num_shapes", type=int, default=512)
    p.add_argument("--json", type=str, default="PRECISION_r03.json")
    p.add_argument("--quick", action="store_true",
                   help="tiny smoke setting (CI): 1 seed, 2 epochs, "
                        "96 shapes")
    a = p.parse_args()
    if a.quick:
        a.seeds, a.nepoch, a.num_shapes = 1, 2, 96

    import numpy as np

    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.data.shapenet_part import (
        make_synthetic_shapenet,
    )
    from adversarial_learning_on_pointclouds.train import runner

    # Keyed on shapes AND points: the cached-fixture guard would
    # otherwise silently reuse a fixture generated at a different
    # points-per-shape count (dir shared with the ablation script).
    root = os.path.join(
        tempfile.gettempdir(),
        f"pointtpu_ablation_shapenet_{a.num_shapes}x{a.num_points}")
    if not (os.path.isdir(root) and os.listdir(root)):
        make_synthetic_shapenet(root, num_shapes=a.num_shapes,
                                num_points=a.num_points)

    runs = []
    for seed in range(a.seeds):
        for mode in ("fp32", "bf16"):
            cfg = AdversarialConfig(
                dataset=root, labeled_ratio=a.ratio, seed=seed,
                batch_size=a.batchSize, num_points=a.num_points,
                epochs=a.nepoch, bf16=(mode == "bf16"),
                ckpt_policy="none", quiet=True,
                out_dir=os.path.join(tempfile.gettempdir(),
                                     f"prec_{seed}_{mode}"))
            t0 = time.perf_counter()
            res = runner.run_adversarial(cfg)
            dt = time.perf_counter() - t0
            row = {"seed": seed, "mode": mode,
                   "best_miou": round(float(res["best_miou"]), 5),
                   "wall_s": round(dt, 1)}
            runs.append(row)
            print(f"[precision] {row}", flush=True)

    summary = {}
    for mode in ("fp32", "bf16"):
        vals = [r["best_miou"] for r in runs if r["mode"] == mode]
        summary[mode] = {"mean": round(float(np.mean(vals)), 5),
                         "std": round(float(np.std(vals)), 5),
                         "runs": vals}
    summary["delta_bf16_minus_fp32"] = round(
        summary["bf16"]["mean"] - summary["fp32"]["mean"], 5)

    out = {"config": {k: getattr(a, k) for k in
                      ("seeds", "ratio", "nepoch", "batchSize",
                       "num_points", "num_shapes")},
           "runs": runs, "summary": summary}
    with open(a.json, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {a.json}")
    print("\n| precision | best mIoU (mean ± std) |")
    print("|---|---|")
    for mode in ("fp32", "bf16"):
        s = summary[mode]
        print(f"| {mode} | {s['mean']:.4f} ± {s['std']:.4f} |")
    print(f"delta (bf16 - fp32): {summary['delta_bf16_minus_fp32']:+.4f}")


if __name__ == "__main__":
    main()
