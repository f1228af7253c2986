"""TRUE multi-host (multi-process) SPMD validation on CPU.

``test_sharding.py`` proves DP/multi-host-mesh equivalence on an emulated
8-device mesh inside ONE process; this script closes the remaining gap to
real multi-host execution (SURVEY.md §2.8, ROADMAP #6): it spawns TWO
OS processes, each owning 4 CPU devices, connects them with
``jax.distributed.initialize`` (gRPC coordinator + Gloo collectives — the
CPU stand-in for the network between hosts), builds the
``('host', 'local')`` mesh over the 8
GLOBAL devices, and runs the full adversarial G+D jitted step with the
batch sharded across both processes (``jax.make_array_from_process_local_
data`` — each process contributes only its local rows, like a real
per-host input pipeline). Every process then recomputes the identical
step on one local device and asserts the distributed losses match at
rel 1e-5 — the same program, mesh-only change, now with cross-process
collectives actually on the wire.

Usage:
  python scripts/multihost_check.py            # launcher: spawns 2 workers
  python scripts/multihost_check.py --worker I --port P   # internal
"""

import argparse
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_PROCS = 2
LOCAL_DEVICES = 4
B, N = 8, 64  # one batch row per global device


def worker(pid: int, port: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", LOCAL_DEVICES)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=NUM_PROCS, process_id=pid)
    assert jax.device_count() == NUM_PROCS * LOCAL_DEVICES
    assert jax.local_device_count() == LOCAL_DEVICES

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig,
    )
    from adversarial_learning_on_pointclouds.parallel import (
        make_multihost_mesh,
    )
    from adversarial_learning_on_pointclouds.parallel.mesh import (
        batch_sharding, replicate_tree,
    )
    from adversarial_learning_on_pointclouds.train import adversarial

    cfg = AdversarialConfig(num_parts=50, batch_size=B, num_points=N,
                            feature_transform=False, augment=False)
    g_tx, d_tx = adversarial.make_txs(cfg, 1)
    state = adversarial.create_state(cfg, 1)

    rng = np.random.default_rng(0)  # same data in every process
    x_l = rng.standard_normal((B, N, 3)).astype(np.float32)
    y_l = rng.integers(0, 50, (B, N)).astype(np.int32)
    x_u = rng.standard_normal((B, N, 3)).astype(np.float32)

    # Single-device reference first (local, no mesh).
    _, m1 = adversarial.train_step(state, jnp.asarray(x_l),
                                   jnp.asarray(y_l), jnp.asarray(x_u),
                                   cfg=cfg, g_tx=g_tx, d_tx=d_tx)
    ref = {k: float(v) for k, v in m1.items()}

    # Distributed: ('host','local') mesh over the 8 global devices; each
    # process feeds ONLY its local batch rows (rows are laid out
    # host-major, so process pid owns rows [pid*B/2, (pid+1)*B/2)).
    mesh = make_multihost_mesh(NUM_PROCS, LOCAL_DEVICES)
    lo, hi = pid * (B // NUM_PROCS), (pid + 1) * (B // NUM_PROCS)

    def dist(arr):
        sh = batch_sharding(mesh, arr.ndim)
        return jax.make_array_from_process_local_data(sh, arr[lo:hi],
                                                      arr.shape)

    state_r = jax.tree_util.tree_map(
        lambda a: jax.make_array_from_process_local_data(
            NamedSharding(mesh, P()), np.asarray(a), np.shape(a)),
        state)
    new_state, m8 = adversarial.train_step(
        state_r, dist(x_l), dist(y_l), dist(x_u),
        cfg=cfg, g_tx=g_tx, d_tx=d_tx)

    worst = 0.0
    for k, v in m8.items():
        got = float(v)  # replicated scalar: readable in every process
        rel = abs(got - ref[k]) / (1.0 + abs(ref[k]))
        worst = max(worst, rel)
        assert rel < 1e-5, (k, got, ref[k])
    # Params must remain fully replicated across BOTH processes' devices.
    leaf = jax.tree_util.tree_leaves(new_state.g_params)[0]
    shards = [np.asarray(s.data) for s in leaf.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_array_equal(shards[0], s)
    print(f"proc {pid}: OK 2-proc x {LOCAL_DEVICES}-dev ('host','local') "
          f"G+D step == single-device, worst rel={worst:.2e}", flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--worker", type=int, default=-1)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args()
    if args.worker >= 0:
        worker(args.worker, args.port)
        return

    with socket.socket() as s:  # pick a free port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         "--worker", str(i), "--port", str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(NUM_PROCS)]
    outs = [pr.communicate(timeout=600)[0].decode() for pr in procs]
    codes = [pr.returncode for pr in procs]
    for i, out in enumerate(outs):
        tail = [ln for ln in out.splitlines()
                if "OK" in ln or "Error" in ln or "assert" in ln]
        print(f"--- worker {i} (exit {codes[i]}):",
              *(tail or out.splitlines()[-3:]), sep="\n")
    if any(codes):
        sys.exit(1)
    print("MULTIHOST OK")


if __name__ == "__main__":
    main()
