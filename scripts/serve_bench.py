#!/usr/bin/env python
"""Serving-path throughput: exported artifact vs live model.

Times eval-mode forward clouds/sec at serving shapes on the GPU for (a)
the deserialized StableHLO artifact (portable XLA lowering, fp32 or
bf16), and (b) the live in-process model on the plain XLA route and on
the kernel route (utils/serving.py, ops/dispatch.py). Exits nonzero when
JAX finds no GPU.

    serve_bench.py --model seg --batch 8 --num_points 2048
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _time(fn, x, iters):
    fn(x).block_until_ready()  # compile + warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(x)
    out.block_until_ready()
    return (time.perf_counter() - t0) / iters


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=("cls", "seg"), default="seg")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--iters", type=int, default=30)
    a = p.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"serve_bench.py: no GPU (JAX platform "
                         f"{jax.devices()[0].platform!r}); not timing")

    from adversarial_learning_on_pointclouds.configs import (
        ClassifyConfig, SegmentConfig,
    )
    from adversarial_learning_on_pointclouds.ops import (
        dispatch, use_pallas,
    )
    from adversarial_learning_on_pointclouds.train import (
        classify, segment,
    )
    from adversarial_learning_on_pointclouds.utils import serving

    if a.model == "cls":
        from adversarial_learning_on_pointclouds.models.classifier \
            import apply_classifier as apply
        cfg = ClassifyConfig(num_points=a.num_points, feature_transform=True)
        st = classify.create_state(cfg, 1)
        export = serving.export_classifier
    else:
        from adversarial_learning_on_pointclouds.models.segmenter \
            import apply_segmenter as apply
        cfg = SegmentConfig(num_points=a.num_points, feature_transform=True)
        st = segment.create_state(cfg, 1)
        export = serving.export_segmenter
    params, bn = st.params, st.bn_state

    x = np.random.default_rng(0).standard_normal(
        (a.batch, a.num_points, 3)).astype(np.float32)
    plats = ("cuda",)
    arts = [
        ("artifact fp32", export(params, bn, a.num_points, a.batch, plats)),
        ("artifact bf16", export(params, bn, a.num_points, a.batch, plats,
                                 bf16=True)),
    ]
    rows = []
    for name, art in arts:
        dt = _time(art.call, x, a.iters)
        rows.append((name, dt))

    for name, pal in (("live XLA fp32", False), ("live kernel fp32", True)):
        with use_pallas(pal):
            paths = dispatch.current_paths()

        @jax.jit
        def live(xx, paths=paths):
            with dispatch.path_context(paths):
                return apply(params, bn, xx, train=False)[0]

        dt = _time(live, x, a.iters)
        rows.append((name, dt))

    for name, dt in rows:
        cps = a.batch / dt
        print(f"{name:<18s} {dt * 1e3:8.3f} ms/batch  {cps:10.1f} clouds/s"
              f"  {cps * a.num_points / 1e6:8.2f} Mpts/s")


if __name__ == "__main__":
    main()
