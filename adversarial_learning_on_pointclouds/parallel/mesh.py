"""Device mesh + sharding layout for data-parallel training.

The reference is single-process single-GPU (SURVEY.md §2.7-2.8); the only
parallelism with reference-parity semantics is DP. Here DP is first-class:
a 1-D ``Mesh(('data',))`` (a reserved ``'model'`` axis is accepted for
future tensor sharding but unused — the model is ~3.5M params), batches
sharded ``P('data')``, parameters/optimizer state replicated. Gradients
and BatchNorm batch statistics are global reductions that XLA's SPMD
partitioner lowers to all-reduces (NCCL over NVLink between the cards of
one host, ``BASELINE.json:5``) — no hand-written collectives needed;
several hosts reuse the same program with a bigger mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(num_devices: int = 0,
              devices: Optional[Sequence[jax.Device]] = None,
              model_axis: int = 1) -> Mesh:
    """1-D (or 2-D with a reserved model axis) device mesh.

    ``num_devices=0`` uses every visible device. ``model_axis > 1`` carves
    a ``'model'`` axis out of the device count (must divide it).
    """
    devs = list(devices) if devices is not None else jax.devices()
    if num_devices:
        devs = devs[:num_devices]
    data = len(devs) // model_axis
    grid = np.asarray(devs).reshape(data, model_axis)
    return Mesh(grid, ("data", "model"))


def make_multihost_mesh(num_hosts: int, chips_per_host: int,
                        devices: Optional[Sequence[jax.Device]] = None
                        ) -> Mesh:
    """2-D ``('host', 'local')`` mesh over several hosts.

    The host axis is OUTERMOST so that, where ``jax.devices()`` orders
    devices host-major, each mesh row is one host's cards: collectives
    along ``'local'`` stay inside a host (the four H100s of one host are
    joined all to all by NVLink) and only the small cross-host reduction
    leaves it. DP batch sharding uses BOTH axes — ``P(('host',
    'local'))`` — so the SPMD partitioner can emit a hierarchical
    all-reduce. Same jitted program as the 1-D ``('data',)`` mesh; only
    the mesh + PartitionSpec change (SURVEY.md §2.8).
    """
    devs = list(devices) if devices is not None else jax.devices()
    devs = devs[: num_hosts * chips_per_host]
    grid = np.asarray(devs).reshape(num_hosts, chips_per_host)
    return Mesh(grid, ("host", "local"))


def data_axes(mesh):
    """The mesh axes a batch shards over: ``'data'`` on the 1-D DP mesh,
    ``('host', 'local')`` on the multi-host mesh. Takes a concrete or an
    abstract mesh."""
    return ("host", "local") if "host" in mesh.shape else "data"


def batch_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    """Shard the leading (batch) axis over the data axes; rest replicated."""
    return NamedSharding(mesh, P(data_axes(mesh), *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """``device_put`` a pytree of host batch arrays with batch sharding."""
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, batch_sharding(mesh, np.ndim(a))), tree)


def replicate_tree(mesh: Mesh, tree):
    """Replicate a pytree (params / optimizer state) across the mesh."""
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)


def point_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    """Shard the POINT axis (axis 1 of ``[B, N, ...]``) over the data
    axes — the sequence-parallel analogue for giant clouds (SURVEY.md §5
    long-context note)."""
    spec = [None] * ndim
    spec[1] = data_axes(mesh)
    return NamedSharding(mesh, P(*spec))


def point_sharded_eval(apply_fn, params, state, x, mesh: Mesh,
                       per_point: "Optional[bool]" = None):
    """Eval-mode forward with the POINT axis sharded across the mesh —
    single-cloud scaling for N far beyond one chip's HBM/latency budget
    (LiDAR-scale scans; the reference caps at ~2.5k points/cloud).

    Every layer is per-point except the symmetric max-pools, which are
    associative — the SPMD partitioner lowers the sharding annotation to
    per-shard partial pools + one tiny ``[B, C]`` all-reduce-max; T-Net
    fc heads and the global feature compute replicated, and per-point
    outputs come back point-sharded. No hand-written collectives. Forces
    the plain XLA path: the trunk-exit kernel splits work by cloud, not
    by point.

    ``apply_fn(params, state, x, train=False) -> (out, ...)`` — the
    classifier or segmenter apply; returns ``out``.

    Arbitrary N is supported: when the point count does not divide the
    mesh's data-axis size (e.g. the reference's N=2500 on 8 devices),
    the cloud is padded by REPEATING its last point up to the next
    multiple and per-point outputs are trimmed back. Duplicating an
    existing point is exact for this architecture — every layer is
    per-point and the pools are max over points, and
    ``max(S ∪ {s})  ==  max(S)`` for ``s`` already in ``S`` — so the
    padded forward computes identical values for the real points.

    ``per_point`` says whether ``apply_fn``'s output keeps the point
    axis at position 1 (segmenter log-probs ``[B, N, k]``: True) or
    pools it away (classifier logits ``[B, num_classes]``: False) —
    it decides whether the pad rows are trimmed from the output. When
    ``None`` it is inferred from the output shape, which is correct
    for both bundled models but can misfire on exotic apply fns whose
    non-point axis-1 length coincides with the padded point count
    (e.g. ``[B, 40]`` logits at ``n + pad == 40``) — pass it
    explicitly in library code.
    """
    from adversarial_learning_on_pointclouds.ops import dispatch

    n = x.shape[1]
    axes = data_axes(mesh)
    axes = axes if isinstance(axes, tuple) else (axes,)
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    pad = (-n) % n_shards
    if pad:
        x = jnp.concatenate(
            [x, jnp.broadcast_to(x[:, -1:], (x.shape[0], pad)
                                 + x.shape[2:])], axis=1)
    xs = jax.device_put(x, point_sharding(mesh, ndim=getattr(x, "ndim", 3)))
    paths = (False, False, dispatch.current_paths()[2])
    out = _point_sharded_fwd(params, state, xs, apply_fn=apply_fn,
                             paths=paths)
    if per_point is None:  # shape inference fallback (see docstring)
        per_point = out.ndim >= 2 and out.shape[1] == n + pad
    if pad and per_point:
        out = out[:, :n]
    return out


def point_sharded_train_step(state, x, y, mesh: Mesh, *, cfg, tx):
    """ONE segmentation training step with the POINT axis sharded over
    the mesh — giant-cloud TRAINING, the train-mode twin of
    ``point_sharded_eval`` (round 4; SURVEY.md §5 long-context note).

    Parameters/optimizer state are replicated; ``x [B, N, 3]`` and the
    per-point labels ``y [B, N]`` are sharded along N. Everything in the
    step is per-point except three reductions, all of which GSPMD lowers
    to per-shard partials + one small collective from the sharding
    annotations alone: the BN batch statistics (mean/var over B·N), the
    symmetric max-pools, and the NLL loss mean — gradients come out
    replicated, so the optimizer update needs no extra communication.
    Forces the plain XLA path (the trunk-exit kernel splits work by
    cloud, not by point).

    Unlike eval, arbitrary N is NOT padded here: a duplicated pad point
    is invisible to a max-pool but would bias the BN batch statistics
    and the per-point loss, so ``N`` must divide the mesh's data-axis
    size. Returns ``(new_state, metrics)`` exactly like
    ``segment.train_step``."""
    from adversarial_learning_on_pointclouds.ops import dispatch
    from adversarial_learning_on_pointclouds.train import segment

    n = x.shape[1]
    axes = data_axes(mesh)
    axes = axes if isinstance(axes, tuple) else (axes,)
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    if n % n_shards:
        raise ValueError(
            f"point_sharded_train_step: N={n} must divide the mesh's "
            f"{n_shards} data shards (padding would bias BN statistics "
            f"and the per-point loss; resample to a multiple instead)")
    xs = jax.device_put(x, point_sharding(mesh, ndim=3))
    ys = jax.device_put(y, point_sharding(mesh, ndim=2))
    state_r = replicate_tree(mesh, state)
    paths = (False, False, dispatch.current_paths()[2])
    return segment._train_step(state_r, xs, ys, cfg=cfg, tx=tx,
                               paths=paths)


@functools.partial(jax.jit, static_argnames=("apply_fn", "paths"))
def _point_sharded_fwd(params, state, x, *, apply_fn, paths):
    # Module-level jit keyed on (apply_fn, paths): repeated
    # point_sharded_eval calls hit the trace cache instead of recompiling
    # the full forward per call.
    from adversarial_learning_on_pointclouds.ops import dispatch

    with dispatch.path_context(paths):
        return apply_fn(params, state, x, train=False)[0]
