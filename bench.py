"""Benchmark: adversarial (G+D) train-step throughput in points/sec/chip.

Headline metric per ``BASELINE.json:2``: points/sec/chip on the combined
generator+discriminator adversarial training step (config 4 shapes: batch
32, 2048 points, 50 parts, feature transform on, on-device augmentation
fused into the step). Baseline target: 1M points/sec/chip
(``BASELINE.json:5``); ``vs_baseline`` is measured/1e6.

Runs as one process on the GPU and prints ONE JSON line that names the
device (JAX platform, device kind and count, ``nvidia-smi`` name and
power limit). Exits nonzero, printing nothing on stdout, when JAX finds
no GPU. Pass ``--steps``/``--batch``/``--points`` to vary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_T0 = time.monotonic()


def _phase(msg: str) -> None:
    """Progress on stderr (stdout stays pure: ONE JSON line)."""
    print(f"# [t+{time.monotonic() - _T0:.0f}s] {msg}",
          file=sys.stderr, flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--no_pallas", action="store_true",
                   help="plain XLA route everywhere (no trunk-exit kernel)")
    p.add_argument("--fp32", action="store_true",
                   help="strict fp32 (HIGHEST) numerics — the torch-parity "
                        "mode; default is bf16 mixed precision")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--fused_forward", action="store_true",
                   help="one combined G fwd / D pass over [labeled; "
                        "unlabeled] (BN stats over the combined 2B batch)")
    p.add_argument("--paired_heads", dest="paired_heads",
                   action="store_true", default=True,
                   help="batch the T-Net fc head matmuls across the two "
                        "streams with per-stream grouped-BN statistics "
                        "(exact sequential semantics). DEFAULT ON")
    p.add_argument("--no_paired_heads", dest="paired_heads",
                   action="store_false",
                   help="sequential per-stream fc heads")
    p.add_argument("--paired_conv1", action="store_true",
                   help="batch the per-point conv1 layers across the two "
                        "streams (grouped per-stream BN1 stats — exact "
                        "sequential semantics)")
    p.add_argument("--scan", type=int, default=8,
                   help="fuse K steps per program launch via lax.scan "
                        "(the runner's --scan mode; 0 = one step per "
                        "launch)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args()

    if args.paired_conv1 and (not args.paired_heads or args.fused_forward):
        p.error("--paired_conv1 requires the paired-heads path "
                "(drop --no_paired_heads / --fused_forward)")

    _phase("importing jax + framework")
    import jax

    from adversarial_learning_on_pointclouds.utils import device

    devices = device.require_gpu("bench.py")

    from adversarial_learning_on_pointclouds.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()

    import numpy as np

    from adversarial_learning_on_pointclouds.configs import AdversarialConfig
    from adversarial_learning_on_pointclouds.ops import (
        mixed_precision, use_pallas,
    )
    from adversarial_learning_on_pointclouds.train import adversarial

    n_chips = len(devices)
    cfg = AdversarialConfig(batch_size=args.batch, num_points=args.points,
                            feature_transform=True, augment=True,
                            use_pallas=not args.no_pallas, bf16=not args.fp32,
                            remat=args.remat, fused_forward=args.fused_forward,
                            paired_heads=args.paired_heads,
                            paired_conv1=args.paired_conv1)
    g_tx, d_tx = adversarial.make_txs(cfg, steps_per_epoch=100)

    rng = np.random.default_rng(0)
    k = max(args.scan, 1)
    shape = (k, args.batch, args.points)
    xlk = jax.device_put(rng.standard_normal(shape + (3,)).astype(np.float32))
    ylk = jax.device_put(rng.integers(0, 50, shape).astype(np.int32))
    xuk = jax.device_put(rng.standard_normal(shape + (3,)).astype(np.float32))

    with use_pallas(cfg.use_pallas), mixed_precision(enabled=cfg.bf16):
        state = adversarial.create_state(cfg, 100)
        if args.scan > 0:
            def step(s):  # K fused steps per launch, K distinct batches
                s, ms = adversarial.train_steps_scan(
                    s, xlk, ylk, xuk, cfg=cfg, g_tx=g_tx, d_tx=d_tx)
                return s, {kk: v[-1] for kk, v in ms.items()}
        else:
            def step(s):
                return adversarial.train_step(s, xlk[0], ylk[0], xuk[0],
                                              cfg=cfg, g_tx=g_tx, d_tx=d_tx)

        _phase("compiling + warmup")
        t0 = time.perf_counter()
        for _ in range(args.warmup):
            state, metrics = step(state)
        jax.block_until_ready((state, metrics))
        compile_s = time.perf_counter() - t0

        _phase(f"measuring {args.steps} launches")
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state)
        jax.block_until_ready((state, metrics))
        dt = (time.perf_counter() - t0) / args.steps
        _phase(f"measured {dt * 1e3:.3f} ms/launch")

    # Labeled + unlabeled clouds, x K when scanning K steps per launch.
    points_per_launch = 2 * args.batch * args.points * k
    pps_per_chip = points_per_launch / dt / n_chips
    losses = {kk: float(v) for kk, v in metrics.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise SystemExit(f"bench.py: non-finite losses {losses}")
    if args.verbose:
        print(f"# warmup+compile {compile_s:.1f}s, {dt * 1e3:.3f} ms/launch, "
              f"losses {losses}", file=sys.stderr)
    print(json.dumps({
        "metric": "adversarial_train_points_per_sec_per_chip",
        "value": pps_per_chip,
        "unit": "points/sec/chip",
        "vs_baseline": pps_per_chip / 1e6,
        "step_ms": dt * 1e3 / k,
        "kernel_route": cfg.use_pallas,
        "device": device.device_record(devices),
        "card": device.card_line(),
    }), flush=True)


if __name__ == "__main__":
    main()
