#!/usr/bin/env python
"""Giant-cloud segmentation trainer: the POINT axis sharded over chips.

The reference lineage caps at ~2.5k points per cloud
(`upstream:dataset.py` fixed-N resample; SURVEY.md §2.1) — one chip's
batch fits easily. LiDAR-scale scans do not: at 10^5-10^6 points the
per-point activations ([B, N, 1088] floats in the seg head) blow past
one card's memory. This trainer runs config-3 segmentation with the point
axis sharded across the mesh via
``parallel.point_sharded_train_step`` / ``point_sharded_eval``: every
layer is per-point except the BN batch statistics, the symmetric
max-pools and the loss mean, which GSPMD lowers to per-shard partials
plus tiny ``[B, C]`` collectives from the sharding annotations
alone. Parameters, optimizer state and gradients stay replicated — no
hand-written collectives anywhere.

Train-step constraint: N must divide the mesh size (padding would bias
the BN statistics; resample to a multiple instead — eval pads/trims
exactly). Forces the plain XLA path: the trunk-exit kernel splits work
by cloud, not by point.

In-memory synthetic fixture when ``--dataset`` is omitted (no datasets
ship with the repo). CPU demo over an emulated 8-device mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        scripts/train_giant_cloud.py --num_points 4096 \
        --num_shapes 16 --batchSize 2 --nepoch 2
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(
        description="point-sharded giant-cloud segmentation")
    p.add_argument("--dataset", type=str, default="",
                   help="ShapeNet-part root ('' = synthetic fixture at "
                        "--num_points resolution)")
    p.add_argument("--num_points", type=int, default=16384)
    p.add_argument("--num_shapes", type=int, default=32,
                   help="synthetic fixture size")
    p.add_argument("--batchSize", type=int, default=4)
    p.add_argument("--nepoch", type=int, default=10)
    p.add_argument("--num_devices", type=int, default=0,
                   help="mesh size (0 = all visible devices)")
    p.add_argument("--feature_transform", action="store_true")
    p.add_argument("--outf", type=str, default="seg_giant")
    p.add_argument("--ckpt_policy", type=str, default="every",
                   choices=["every", "latest", "best", "none"],
                   help="per-epoch checkpointing: every epoch (blocking "
                        "backpressure), skip-to-latest, best-eval-epoch "
                        "only, or none")
    p.add_argument("--eval_every", type=int, default=1,
                   help="run the (point-sharded) eval pass every K-th "
                        "epoch + always the final one")
    p.add_argument("--class_choice", type=str, default=None)
    a = p.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from adversarial_learning_on_pointclouds.configs import SegmentConfig
    from adversarial_learning_on_pointclouds.data.loader import (
        host_batch_iterator, num_batches,
    )
    from adversarial_learning_on_pointclouds.models.segmenter import (
        apply_segmenter,
    )
    from adversarial_learning_on_pointclouds.parallel import (
        make_mesh, point_sharded_eval, point_sharded_train_step,
    )
    from adversarial_learning_on_pointclouds.train import runner, segment
    from adversarial_learning_on_pointclouds.utils import checkpoint
    from adversarial_learning_on_pointclouds.utils.logging import (
        MetricLogger,
    )
    from adversarial_learning_on_pointclouds.utils.metrics import (
        shape_ious_device,
    )

    mesh = make_mesh(a.num_devices)
    n_shards = int(np.prod([mesh.shape[ax] for ax in mesh.axis_names
                            if ax != "model"]))
    if a.num_points % n_shards:
        p.error(f"--num_points {a.num_points} must divide the mesh's "
                f"{n_shards} data shards (BN statistics must not see "
                f"pad points; resample to a multiple)")

    cfg = SegmentConfig(
        dataset=a.dataset,
        num_points=a.num_points, batch_size=a.batchSize,
        epochs=a.nepoch, feature_transform=a.feature_transform,
        class_choice=a.class_choice, out_dir=a.outf,
        use_pallas=False,     # point-sharded: plain XLA path
        device_data=False, scan=0, resample=False,
    )
    if a.dataset:
        (x_tr, s_tr, _c_tr), (x_te, s_te, c_te) = runner._shapenet_arrays(
            cfg)
    else:
        from adversarial_learning_on_pointclouds.data.shapenet_part \
            import synthetic_shapenet
        splits = synthetic_shapenet(num_shapes=a.num_shapes,
                                    num_points=a.num_points,
                                    cluster_parts=True,
                                    class_choice=a.class_choice)
        x_tr, s_tr = splits["train"].points, splits["train"].part_labels
        x_te, s_te, c_te = (splits["test"].points,
                            splits["test"].part_labels,
                            splits["test"].category)
        if cfg.normalize:
            from adversarial_learning_on_pointclouds.data import augment
            x_te = augment.normalize_unit_sphere_np(x_te)
    spe = num_batches(len(x_tr), cfg.batch_size)
    if a.nepoch < 1 or spe < 1:
        p.error(f"nothing to train: {a.nepoch} epochs x {spe} "
                f"steps/epoch (train set {len(x_tr)} shapes < "
                f"--batchSize {a.batchSize}?)")
    tx = segment.make_tx(cfg, spe)
    state = segment.create_state(cfg, spe)
    logger = MetricLogger(cfg.out_dir, "seg_giant", quiet=cfg.quiet)
    print(f"[giant] mesh={dict(zip(mesh.axis_names, mesh.devices.shape))} "
          f"N={a.num_points} ({a.num_points // n_shards}/shard) "
          f"batch={a.batchSize} train={len(x_tr)} test={len(x_te)}",
          flush=True)

    best = 0.0
    saver = checkpoint.AsyncSaver(a.ckpt_policy)
    for epoch in range(a.nepoch):
        t0 = time.perf_counter()
        for batch in host_batch_iterator((x_tr, s_tr), cfg.batch_size,
                                         shuffle=True, seed=cfg.seed,
                                         epoch=epoch, drop_last=True):
            state, m = point_sharded_train_step(
                state, batch[0], batch[1], mesh, cfg=cfg, tx=tx)
        train_s = time.perf_counter() - t0

        if not ((epoch + 1) % max(a.eval_every, 1) == 0
                or epoch == a.nepoch - 1):
            # Skipped-eval epoch (--eval_every): no epoch row (the CSV
            # schema is fixed by its first row), no save under 'best'
            # (nothing measured to rank the epoch by).
            if a.ckpt_policy != "best":
                saver.save(cfg.out_dir, epoch, state)
            continue

        # Eval: point-sharded forward, IoU reduction on the host. The
        # batch axis is NOT sharded, so the ragged final batch needs no
        # padding — plain slices, no mask bookkeeping.
        ious, accs = [], []
        for i in range(0, len(x_te), cfg.batch_size):
            xb = x_te[i:i + cfg.batch_size]
            yb = s_te[i:i + cfg.batch_size]
            cb = c_te[i:i + cfg.batch_size]
            out = point_sharded_eval(apply_segmenter, state.params,
                                     state.bn_state, xb, mesh,
                                     per_point=True)
            pred = jnp.argmax(out, -1)
            ious.append(np.asarray(shape_ious_device(
                pred, jnp.asarray(yb), jnp.asarray(cb))))
            accs.append(np.asarray(pred == jnp.asarray(yb)).mean(axis=1))
        miou = float(np.concatenate(ious).mean())
        best = max(best, miou)
        logger.log_epoch(
            epoch,
            instance_miou=miou,
            point_accuracy=float(np.concatenate(accs).mean()),
            loss=float(m["loss"]),
            train_s=round(train_s, 3),
            eval_s=round(time.perf_counter() - t0 - train_s, 3))
        saver.save(cfg.out_dir, epoch, state, metric=miou)
    saver.close()  # drains: the final epoch is durable before returning
    logger.close()
    print(f"[giant] best instance mIoU {best:.4f}")
    return best


if __name__ == "__main__":
    main()
