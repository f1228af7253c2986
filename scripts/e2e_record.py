"""On-chip E2E throughput records for the single-network configs.

Counterpart of ``scripts/e2e_adversarial_record.py`` (config 4) for
configs 1-2 (classification), 3 (segmentation), and 5 (FGSM adversarial
perturbation): the FULL runner — index streams, on-device gather +
augment chain, jitted steps (``--scan K`` fused launches), per-epoch
compiled eval scan, async checkpoints — on a large synthetic fixture,
timed wall-clock including the host pipeline and first-compile, on
the GPU (exits nonzero without one). The fixtures are written as HDF5,
so these records need ``h5py`` (``pip install .[h5]``).
Steady-state per-epoch costs come from the logged train_s/eval_s/ckpt_s.
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
    p.add_argument("--config", choices=("cls", "seg", "advp"),
                   default="cls")
    p.add_argument("--shapes", type=int, default=2048)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--scan", type=int, default=8)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--outf", type=str, default="")
    args = p.parse_args()

    from adversarial_learning_on_pointclouds.utils import device
    from adversarial_learning_on_pointclouds.utils.compile_cache import (
        enable_persistent_cache,
    )

    devices = device.require_gpu("e2e_record.py")

    enable_persistent_cache()

    from adversarial_learning_on_pointclouds.configs import (
        AdvPerturbConfig, ClassifyConfig, SegmentConfig,
    )
    from adversarial_learning_on_pointclouds.data import (
        make_synthetic_modelnet_h5, make_synthetic_shapenet,
    )
    from adversarial_learning_on_pointclouds.train import runner

    tmp = tempfile.gettempdir()
    out = args.outf or os.path.join(tmp, f"pointtpu_e2e_{args.config}")
    kw = dict(num_points=args.points, batch_size=args.batch,
              epochs=args.epochs, feature_transform=True,
              augment=args.augment, bf16=True, scan=args.scan,
              out_dir=out, quiet=True)

    if args.config == "seg":
        root = os.path.join(tmp, f"pointtpu_e2e_sn_{args.shapes}x{args.points}")
        if not (os.path.isdir(root) and os.listdir(root)):
            make_synthetic_shapenet(root, num_shapes=args.shapes,
                                    num_points=args.points)
        cfg = SegmentConfig(dataset=root, **kw)
        n_train = int(0.75 * args.shapes)
        run, key = runner.run_segmentation, "best_miou"
    else:
        root = os.path.join(tmp, f"pointtpu_e2e_mn_{args.shapes}x{args.points}")
        if not os.path.exists(os.path.join(root, "train_files.txt")):
            make_synthetic_modelnet_h5(root, num_train=args.shapes,
                                       num_test=args.shapes // 4,
                                       num_points=args.points)
        n_train = args.shapes
        if args.config == "advp":
            cfg = AdvPerturbConfig(dataset=root, epsilon=0.05, **kw)
            run, key = runner.run_adv_perturb, "best_accuracy"
        else:
            cfg = ClassifyConfig(dataset=root, **kw)
            run, key = runner.run_classification, "best_accuracy"

    spe = n_train // args.batch
    t0 = time.perf_counter()
    result = run(cfg)
    wall = time.perf_counter() - t0
    pts = args.batch * args.points * spe * args.epochs
    n_chips = len(devices)
    print(json.dumps({
        "metric": f"{args.config}_e2e_epoch_throughput",
        "shapes": args.shapes, "points": args.points, "batch": args.batch,
        "epochs": args.epochs, "scan": args.scan,
        "wall_s": round(wall, 1),
        "epochs_per_sec": round(args.epochs / wall, 4),
        "points_per_sec_per_chip_incl_host": round(pts / wall / n_chips, 1),
        "device": device.device_record(devices),
        "card": device.card_line(),
        "best": round(float(result[key]), 4),
    }))


if __name__ == "__main__":
    main()
