#!/usr/bin/env python
"""End-to-end check that the adversarial G+D trainer runs on one GPU.

One process, run from the root of a checkout on a machine with an NVIDIA
card (``python chip_smoke.py``). Phases, each of which must pass:

1. The card: ``nvidia-smi`` name and power limit, JAX's device kind and
   version.
2. Compiled trunk-exit kernel vs. the plain route at full width
   (``tests/test_gpu.py``, marker ``gpu``, run in this process).
3. The main path: ``scripts/train_adversarial.py`` (config 4: batch 32,
   2048 points, 50 parts, feature transform, bf16) on generated
   ShapeNet-part data for a few steps and one eval pass; every logged
   loss must be finite.
4. The config-4 ``--scan 8`` launch (the bench's default) on the kernel
   route vs. the plain route: first-step losses at the bf16 bound, each
   program's ``memory_analysis()``, peak bytes.
5. Route A/B timing of those two compiled programs, alternating in this
   process (warm-up excluded, ``block_until_ready``).
6. The trunk exit alone at config-4 widths: the extrema kernel vs. the
   program XLA compiles for the same pool, and the train trunk exit
   (forward and backward) on both routes, timed alternating.

``--chips 4`` runs only the four-card phase instead: the config-4 DP
step on four cards vs. one card on the same global batch (fp32 and
bf16), and the point-sharded segmentation step vs. the replicated one.

The last line of stdout is one JSON object naming the device. The script
exits nonzero, and prints no such line, when JAX finds no GPU, when the
repository is not beside it, or when any phase fails.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import runpy
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
BATCH, POINTS = 32, 2048     # config 4 at full width

_T0 = time.monotonic()


def say(msg: str) -> None:
    print(f"[chip_smoke t+{time.monotonic() - _T0:6.1f}s] {msg}", flush=True)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _config4(bf16: bool = True):
    from adversarial_learning_on_pointclouds.configs import AdversarialConfig

    return AdversarialConfig(batch_size=BATCH, num_points=POINTS, num_parts=50,
                             feature_transform=True, augment=True, bf16=bf16)


def _config4_batch(cfg, seed: int = 0):
    """Labeled + unlabeled config-4 batches from the generated
    ShapeNet-part fixture."""
    import numpy as np

    from adversarial_learning_on_pointclouds.data import synthetic_shapenet

    train = synthetic_shapenet(num_shapes=96, num_points=cfg.num_points,
                               seed=seed)["train"]
    b = cfg.batch_size
    return (np.asarray(train.points[:b]), np.asarray(train.part_labels[:b]),
            np.asarray(train.points[b:2 * b]))


def phase_kernel_parity() -> None:
    import pytest

    say("phase 2: compiled trunk kernel vs plain route (tests/test_gpu.py)")
    rc = pytest.main(["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests",
                                                        "test_gpu.py")])
    if rc != 0:
        raise SystemExit(f"chip_smoke: gpu test suite failed (pytest rc {rc})")


def phase_trainer() -> None:
    out = os.path.join(OUT, "adv")
    if os.path.isdir(out):
        shutil.rmtree(out)
    say(f"phase 3: scripts/train_adversarial.py, config 4 at "
        f"{BATCH}x{POINTS} bf16")
    argv = ["train_adversarial.py", "--num_devices", "1",
            "--batchSize", str(BATCH), "--num_points", str(POINTS),
            "--feature_transform", "--bf16",
            "--nepoch", "3", "--eval_every", "3", "--ckpt_policy", "latest",
            "--outf", out]
    saved = sys.argv
    sys.argv = argv
    try:
        runpy.run_path(os.path.join(ROOT, "scripts", "train_adversarial.py"),
                       run_name="__main__")
    finally:
        sys.argv = saved
    with open(os.path.join(out, "adv_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise SystemExit("chip_smoke: the trainer logged no steps")
    for row in rows:
        losses = {k: float(v) for k, v in row.items() if k.startswith("loss")}
        if not losses or not all(math.isfinite(v) for v in losses.values()):
            raise SystemExit(f"chip_smoke: non-finite losses {row}")
        say("  step %s: %s" % (row["step"], " ".join(
            f"{k}={v:.4f}" for k, v in losses.items())))
    # The checkpoint round-trips; then the step directories go (they are
    # larger than what a run may bring back).
    from adversarial_learning_on_pointclouds.configs import (
        adversarial_config_from_args,
    )
    from adversarial_learning_on_pointclouds.train import adversarial
    from adversarial_learning_on_pointclouds.utils import checkpoint

    step = checkpoint.latest_step(out)
    template = adversarial.create_state(
        adversarial_config_from_args(argv[1:]), 1)
    checkpoint.restore(out, template, step)
    say(f"  checkpoint {step} restored")
    for name in os.listdir(out):
        if name.isdigit():
            shutil.rmtree(os.path.join(out, name))


def phase_routes(devices, rounds: int = 4, launches: int = 5,
                 k: int = 8) -> dict:
    """Phases 4 and 5 on one compiled program per route: the config-4
    ``--scan k`` launch (the bench's default), K batches drawn from the
    generated fixture."""
    import jax
    import numpy as np

    from adversarial_learning_on_pointclouds.ops import (
        dispatch, mixed_precision, use_pallas,
    )
    from adversarial_learning_on_pointclouds.train import adversarial

    say(f"phase 4: config-4 scan-{k} launch, kernel route vs plain route")
    cfg = _config4()
    g_tx, d_tx = adversarial.make_txs(cfg, 100)
    x, y, _ = _config4_batch(cfg)
    rng = np.random.default_rng(1)
    pick = rng.integers(0, len(x), (2, k, cfg.batch_size))
    xs, ys, us = (jax.device_put(a) for a in (x[pick[0]], y[pick[0]],
                                              x[pick[1]]))
    programs, states, first = {}, {}, {}
    for route in (True, False):
        name = "kernel" if route else "plain"
        with use_pallas(route), mixed_precision():
            state = adversarial.create_state(cfg, 100)
            programs[route] = adversarial._train_steps_scan_jit.lower(
                state, xs, ys, us, cfg=cfg, g_tx=g_tx, d_tx=d_tx,
                paths=dispatch.current_paths()).compile()
        say(f"  {name} route memory_analysis: "
            f"{programs[route].memory_analysis()}")
        states[route], ms = programs[route](state, xs, ys, us)
        first[route] = {kk: float(v[0]) for kk, v in ms.items()}
        if not all(np.isfinite(np.asarray(v)).all() for v in ms.values()):
            raise SystemExit(f"chip_smoke: non-finite {name} losses {ms}")
        say(f"  {name} route, step 1: " + " ".join(
            f"{kk}={v:.6f}" for kk, v in first[route].items()))
    for key in ("loss_g", "loss_d"):
        r = _rel(first[True][key], first[False][key])
        say(f"  {key}: kernel vs plain rel {r:.2e} (bound 2e-2)")
        if r > 2e-2:
            raise SystemExit(f"chip_smoke: {key} routes disagree ({r:.2e})")
    stats = devices[0].memory_stats() or {}
    say(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    say(f"phase 5: route A/B timing, {rounds} rounds x {launches} "
        f"launches, alternating")
    times = {True: [], False: []}
    for route in (True, False):        # one more warm-up launch each
        states[route], ms = programs[route](states[route], xs, ys, us)
        jax.block_until_ready((states[route], ms))
    for _ in range(rounds):
        for route in (True, False):
            t0 = time.perf_counter()
            for _ in range(launches):
                states[route], ms = programs[route](states[route], xs, ys,
                                                    us)
            jax.block_until_ready((states[route], ms))
            times[route].append((time.perf_counter() - t0) / (launches * k))
    res = {("kernel" if r else "plain"): statistics.median(v) * 1e3
           for r, v in times.items()}
    for name, ms_step in res.items():
        pts = 2 * cfg.batch_size * cfg.num_points / (ms_step / 1e3)
        say(f"  {name} route: {ms_step:.4f} ms/step median of {rounds} "
            f"({pts:.0f} points/sec/chip); per round "
            + ", ".join(f"{t * 1e3:.4f}" for t in
                        times[name == "kernel"]))
    return res


def phase_trunk_alone(rounds: int = 5, reps: int = 20) -> dict:
    """Phase 6: the trunk exit alone at config-4 widths (B=32, N=2048,
    128 -> 1024, bf16 operands): the extrema kernel vs. the program XLA
    compiles for ``max_n(h @ w + b)``, and the train trunk exit (forward
    and backward) on the kernel route vs. the plain route."""
    import jax
    import jax.numpy as jnp

    from adversarial_learning_on_pointclouds.models import core
    from adversarial_learning_on_pointclouds.ops import dispatch
    from adversarial_learning_on_pointclouds.ops.kernels import trunk_pool

    say(f"phase 6: trunk exit alone, B={BATCH} N={POINTS} 128->1024 bf16, "
        f"{rounds} rounds x {reps} calls, alternating")
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    h = jax.nn.relu(jax.random.normal(keys[0], (BATCH, POINTS, 128)))
    dense = core.torch_linear_init(keys[1], 128, 1024)
    bn_p, bn_s = core.bn_init(1024)
    ct = jax.random.normal(keys[2], (BATCH, 1024), jnp.float32)
    hq, wq = h.astype(jnp.bfloat16), dense["w"].astype(jnp.bfloat16)

    def xla_pool(hq, wq, b):
        z = jnp.matmul(hq, wq, preferred_element_type=jnp.float32) + b
        return jnp.max(z, axis=1)

    def train_exit(route):
        def loss(dense, bn_p, h):
            with dispatch.use_pallas(route), core.mixed_precision():
                g, _ = dispatch.linear_bn_maxpool(dense, bn_p, bn_s, h, True)
            return jnp.sum(g.astype(jnp.float32) * ct)
        return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))

    pool_args = (hq, wq, dense["b"])
    train_args = (dense, bn_p, h)
    calls = {
        "extrema kernel": (jax.jit(lambda *a: trunk_pool.extrema(*a)[0]),
                           pool_args),
        "XLA max(h@w+b)": (jax.jit(xla_pool), pool_args),
        "train exit, kernel route": (train_exit(True), train_args),
        "train exit, plain route": (train_exit(False), train_args),
    }
    first = {name: jax.block_until_ready(f(*a))     # compile + warm-up
             for name, (f, a) in calls.items()}
    ref = first["XLA max(h@w+b)"]
    r = float(jnp.max(jnp.abs(first["extrema kernel"] - ref))
              / jnp.max(jnp.abs(ref)))
    say(f"  extrema kernel vs XLA: max|d|/max|ref| {r:.2e} (bound 2e-2)")
    if r > 2e-2:
        raise SystemExit(f"chip_smoke: extrema kernel disagrees ({r:.2e})")
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, (f, a) in calls.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                out = f(*a)
            jax.block_until_ready(out)
            times[name].append((time.perf_counter() - t0) / reps)
    res = {name: statistics.median(v) * 1e3 for name, v in times.items()}
    for name, ms in res.items():
        say(f"  {name}: {ms:.4f} ms median of {rounds}; per round "
            + ", ".join(f"{t * 1e3:.4f}" for t in times[name]))
    return res


def phase_four_cards(devices) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from adversarial_learning_on_pointclouds.configs import SegmentConfig
    from adversarial_learning_on_pointclouds.ops import (
        mixed_precision, use_pallas,
    )
    from adversarial_learning_on_pointclouds.parallel import (
        make_mesh, point_sharded_train_step, shard_batch,
    )
    from adversarial_learning_on_pointclouds.parallel.mesh import (
        replicate_tree,
    )
    from adversarial_learning_on_pointclouds.train import adversarial, segment

    # fp32 (HIGHEST) holds the two programs to 1e-4: they differ only
    # in reduction order. In bf16 the operand casts turn those last-bit
    # differences into bf16 rounding flips (and the semi-loss mask is a
    # threshold), so bf16 is held to the bf16 bound used everywhere else.
    for bf16, bound in ((False, 1e-4), (True, 2e-2)):
        prec = "bf16" if bf16 else "fp32"
        say(f"four-card phase: config-4 DP step {prec}, 4 cards vs 1, same "
            f"global batch")
        cfg = _config4(bf16=bf16)
        g_tx, d_tx = adversarial.make_txs(cfg, 100)
        batch = _config4_batch(cfg)
        got = {}
        for n_dev in (4, 1):
            mesh = make_mesh(n_dev)
            with jax.set_mesh(mesh), use_pallas(True), \
                    mixed_precision(enabled=bf16):
                state = replicate_tree(mesh,
                                       adversarial.create_state(cfg, 100))
                x_l, y_l, x_u = shard_batch(mesh, batch)
                _, m = adversarial.train_step(state, x_l, y_l, x_u, cfg=cfg,
                                              g_tx=g_tx, d_tx=d_tx)
                got[n_dev] = {k: float(v) for k, v in m.items()}
            say(f"  {n_dev} card(s): " + " ".join(
                f"{k}={v:.6f}" for k, v in got[n_dev].items()))
        for key in ("loss_g", "loss_ce", "loss_adv", "loss_semi", "loss_d"):
            r = _rel(got[4][key], got[1][key])
            say(f"  {prec} {key}: 4 vs 1 rel {r:.2e} (bound {bound:g})")
            if r > bound:
                raise SystemExit(f"chip_smoke: DP {prec} {key} 4 vs 1 rel "
                                 f"{r:.2e}")

    say("four-card phase: point-sharded seg step vs replicated step")
    n = 2 * POINTS
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, n, 3)).astype(np.float32)
    y = rng.integers(0, 50, (8, n)).astype(np.int32)
    scfg = SegmentConfig(num_points=n, batch_size=8, feature_transform=True,
                         augment=False)
    tx = segment.make_tx(scfg, 1)
    state = segment.create_state(scfg, 1)
    paths = (False, False, None)
    _, ref = segment._train_step(state, jnp.asarray(x), jnp.asarray(y),
                                 cfg=scfg, tx=tx, paths=paths)
    _, sh = point_sharded_train_step(state, x, y, make_mesh(4), cfg=scfg,
                                     tx=tx)
    r = _rel(float(sh["loss"]), float(ref["loss"]))
    say(f"  loss point-sharded {float(sh['loss']):.6f} vs replicated "
        f"{float(ref['loss']):.6f}: rel {r:.2e} (bound 1e-4)")
    if r > 1e-4:
        raise SystemExit(f"chip_smoke: point-sharded step rel {r:.2e}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4),
                   help="4: run only the four-card phase")
    args = p.parse_args()

    import jax

    from adversarial_learning_on_pointclouds.utils import device
    from adversarial_learning_on_pointclouds.utils.compile_cache import (
        enable_persistent_cache,
    )

    devices = device.require_gpu("chip_smoke.py")
    if len(devices) < args.chips:
        raise SystemExit(f"chip_smoke: --chips {args.chips} but JAX sees "
                         f"{len(devices)} device(s)")
    say(f"compile cache: {enable_persistent_cache()}")
    os.makedirs(OUT, exist_ok=True)
    print(device.card_line(), flush=True)
    say(f"device_kind={devices[0].device_kind} count={len(devices)} "
        f"jax={jax.__version__}")
    say("note: a float32 product on the GPU runs in TF32 (about three "
        "decimal digits) unless a precision is asked for; the fp32 "
        "references here pin Precision.HIGHEST")

    if args.chips == 4:
        phase_four_cards(devices)
    else:
        phase_kernel_parity()
        phase_trainer()
        timing = phase_routes(devices)
        trunk = phase_trunk_alone()
        with open(os.path.join(OUT, "route_timing.json"), "w") as f:
            json.dump({"ms_per_step": timing, "trunk_exit_ms": trunk,
                       "card": device.card_line(),
                       "device": device.device_record(devices)}, f)
    print(json.dumps({"ok": True, "device": device.device_record(devices)}),
          flush=True)


if __name__ == "__main__":
    main()
