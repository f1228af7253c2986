"""Config-4 E2E on-chip record: the full adversarial runner (loader,
augment chain, G+D steps, per-epoch eval + checkpointing) on a large
synthetic ShapeNet fixture, timed wall-clock (VERDICT round 1, next-round
#3 — the adversarial counterpart of the classification 222 s demo).

Measures epochs/sec and points/sec/chip INCLUDING the host input pipeline,
unlike bench.py's device-resident kernel-throughput metric. Runs on the
GPU (exits nonzero without one); the fixture is written as HDF5, so it
needs ``h5py`` (``pip install .[h5]``).
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
    p.add_argument("--shapes", type=int, default=2048)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--scan", type=int, default=0)
    p.add_argument("--fused_epoch", action="store_true",
                   help="one compiled launch per epoch (train scan + "
                        "eval scan) — VERDICT r2 next #3")
    p.add_argument("--ckpt_policy", type=str, default="every",
                   choices=("every", "latest", "none"))
    p.add_argument("--augment", action="store_true",
                   help="rotate/jitter on (NB the synthetic fixture's "
                        "labels are axis-aligned, so rotation hurts its "
                        "learnability — off by default for the record)")
    p.add_argument("--outf", type=str, default="")
    args = p.parse_args()

    from adversarial_learning_on_pointclouds.utils import device
    from adversarial_learning_on_pointclouds.utils.compile_cache import (
        enable_persistent_cache,
    )

    devices = device.require_gpu("e2e_adversarial_record.py")

    enable_persistent_cache()

    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.data import (
        make_synthetic_shapenet,
    )
    from adversarial_learning_on_pointclouds.train import runner

    root = os.path.join(tempfile.gettempdir(),
                        f"pointtpu_e2e_sn_{args.shapes}x{args.points}")
    if not (os.path.isdir(root) and os.listdir(root)):
        make_synthetic_shapenet(root, num_shapes=args.shapes,
                                num_points=args.points)
    out = args.outf or os.path.join(tempfile.gettempdir(), "pointtpu_e2e_adv")
    cfg = AdversarialConfig(
        dataset=root, num_points=args.points, batch_size=args.batch,
        epochs=args.epochs, labeled_ratio=0.5, feature_transform=True,
        augment=args.augment, bf16=True, scan=args.scan, out_dir=out,
        fused_epoch=args.fused_epoch, ckpt_policy=args.ckpt_policy,
        quiet=True)

    n_train = int(0.75 * args.shapes)
    n_lab = max(int(n_train * 0.5), args.batch)
    spe = n_lab // args.batch
    t0 = time.perf_counter()
    result = runner.run_adversarial(cfg)
    wall = time.perf_counter() - t0
    steps = spe * args.epochs
    pts = 2 * args.batch * args.points * steps
    n_chips = len(devices)
    print(json.dumps({
        "metric": "adversarial_e2e_epoch_throughput",
        "shapes": args.shapes, "points": args.points, "batch": args.batch,
        "epochs": args.epochs, "scan": args.scan,
        "fused_epoch": args.fused_epoch,
        "wall_s": round(wall, 1),
        "epochs_per_sec": round(args.epochs / wall, 4),
        "points_per_sec_per_chip_incl_host": round(pts / wall / n_chips, 1),
        "device": device.device_record(devices),
        "card": device.card_line(),
        "best_miou": round(float(result["best_miou"]), 4),
    }))


if __name__ == "__main__":
    main()
