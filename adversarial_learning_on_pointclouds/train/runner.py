"""Full training runs for the five baseline configs — the engine behind
the CLI scripts (SURVEY.md §2.6; call stack §3.1).

Each runner: loads data (in-memory synthetic fixtures when
``cfg.dataset`` is empty — no datasets ship with the repo), builds the DP
mesh,
replicates state, iterates epochs with prefetched sharded batches,
evaluates per epoch, checkpoints per epoch, and logs CSV/stdout metrics
including the points/sec/chip meter.
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Tuple

import jax
import numpy as np

from adversarial_learning_on_pointclouds import eval as eval_lib
from adversarial_learning_on_pointclouds.configs import (
    AdversarialConfig, AdvPerturbConfig, ClassifyConfig, SegmentConfig,
)
from adversarial_learning_on_pointclouds.data import (
    ModelNet40, ShapeNetPart, synthetic_modelnet_arrays, synthetic_shapenet,
)
from adversarial_learning_on_pointclouds.data import augment as aug_lib
from adversarial_learning_on_pointclouds.data import loader
from adversarial_learning_on_pointclouds.data.loader import num_batches
from adversarial_learning_on_pointclouds.ops import (
    mixed_precision, use_pallas,
)
from adversarial_learning_on_pointclouds.parallel import (
    batch_sharding, make_mesh,
)
from adversarial_learning_on_pointclouds.parallel.mesh import (
    replicate_tree,
)
from adversarial_learning_on_pointclouds.train import (
    adv_perturb, adversarial, classify, segment,
)
from adversarial_learning_on_pointclouds.utils import checkpoint
from adversarial_learning_on_pointclouds.utils.logging import MetricLogger
from adversarial_learning_on_pointclouds.utils.profiling import maybe_trace


def _subsample(points: np.ndarray, num_points: int, seed: int) -> np.ndarray:
    if points.shape[1] == num_points:
        return points
    rng = np.random.default_rng(seed)
    idx = rng.choice(points.shape[1], num_points,
                     replace=points.shape[1] < num_points)
    return points[:, idx]


def _modelnet_arrays(cfg, eval_split: str = "test") -> Tuple[
        np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Train arrays keep the full source resolution when ``cfg.resample``
    (the jitted step draws a fresh fixed-N subsample per batch, matching
    the reference's per-``__getitem__`` ``np.random.choice``); the eval
    split (``test`` default; eval CLIs expose ``--split``) is prepared
    deterministically on the host — normalize over the full point set,
    then one seeded subsample."""
    if cfg.dataset:
        train = ModelNet40(cfg.dataset, "train")
        test = ModelNet40(cfg.dataset, eval_split)
    else:
        train, test = synthetic_modelnet_arrays()
        test = train if eval_split == "train" else test

    x_tr = train.points
    if not cfg.resample:
        x_tr = _subsample(x_tr, cfg.num_points, cfg.seed)
    x_te = test.points
    if cfg.normalize:
        x_te = aug_lib.normalize_unit_sphere_np(x_te)
    x_te = _subsample(x_te, cfg.num_points, cfg.seed + 1)
    return x_tr, train.labels, x_te, test.labels


def _shapenet_arrays(cfg, eval_split: str = "test"):
    if cfg.dataset:
        train = ShapeNetPart(cfg.dataset, "train",
                             class_choice=cfg.class_choice)
        try:
            test = ShapeNetPart(cfg.dataset, eval_split,
                                class_choice=cfg.class_choice)
        except (FileNotFoundError, OSError):
            if eval_split != "test":
                raise  # an explicitly requested --split must exist
            test = train
    else:
        splits = synthetic_shapenet(num_shapes=96, num_points=cfg.num_points,
                                    class_choice=cfg.class_choice)
        train, test = splits["train"], splits[eval_split]
    if cfg.resample:
        # Rectangular pool at (at least) source resolution; the jitted
        # step resamples fixed-N fresh per batch on device.
        tr = train.as_pool_arrays(cfg.num_points, seed=cfg.seed)
    else:
        tr = train.as_arrays(cfg.num_points, seed=cfg.seed)
    x_te, s_te, c_te = test.as_arrays(cfg.num_points, seed=cfg.seed + 1)
    if cfg.normalize:
        x_te = aug_lib.normalize_unit_sphere_np(x_te)
    return tr, (x_te, s_te, c_te)


def _setup(cfg):
    """The DP mesh, its chip count and the batch sharding. The runners
    also enter the mesh as the context mesh (``jax.set_mesh``), which is
    how the trunk-exit kernel finds the batch axes to run per device."""
    mesh = make_mesh(cfg.num_devices)
    n_chips = mesh.shape["data"] * mesh.shape["model"]
    sharding = batch_sharding(mesh, 3)
    return mesh, n_chips, sharding


def _prefetch_depth(cfg) -> int:
    """``--workers N`` -> host prefetch depth (N batches staged ahead of
    consumption; the reference's ``num_workers`` analogue). 0 keeps the
    default double-buffering of 2."""
    return cfg.workers if cfg.workers > 0 else 2


def _single_net_epoch(cfg, mod, state, tx, epoch, sharding, logger, spe,
                      pts_per_step, n_chips, step_h, pools=None,
                      arrays=None):
    """One training epoch for a single-network trainer (configs 1-3, 5).

    Default (``cfg.device_data``): the train pools live in HBM
    (``pools = (pool_x, pool_y, n)``), the host streams ``[B]`` int32
    index vectors, and ``mod.train_step_gather`` selects the rows on
    device; with ``--scan K`` the stacked ``[K, B]`` index groups launch
    ``mod.train_steps_scan_gather``. ``--host_data`` streams assembled
    batches from ``arrays`` instead (reference DataLoader model; stacked
    groups launch ``mod.train_steps_scan``). Both paths consume the same
    permutation stream (``loader.host_index_iterator`` contract).

    ``step_h`` is the HOST-side step counter (deterministic: initial step
    + batches consumed); logging from it instead of ``int(state.step)``
    avoids a blocking device readback per launch, which would serialize
    launches and defeat the logger's pipelined readbacks. Returns
    ``(state, step_h)``."""
    if cfg.device_data:
        pool_x, pool_y, n = pools
        src = ((i,) for i in loader.host_index_iterator(
            n, cfg.batch_size, seed=cfg.seed, epoch=epoch))
    else:
        src = loader.host_batch_iterator(arrays, cfg.batch_size,
                                         seed=cfg.seed, epoch=epoch)
    bi = 0
    for batch, stacked in loader.device_batches(
            src, sharding, k_stack=cfg.scan,
            prefetch=_prefetch_depth(cfg)):
        if stacked:
            if cfg.device_data:
                state, ms = mod.train_steps_scan_gather(
                    state, pool_x, pool_y, batch[0], cfg=cfg, tx=tx)
            else:
                state, ms = mod.train_steps_scan(state, *batch, cfg=cfg,
                                                 tx=tx)
            k = batch[0].shape[0]
            step_h += k
            logger.log_scan_steps(epoch, bi, spe, step_h, ms, k,
                                  pts_per_step, n_chips)
            bi += k
            continue
        if cfg.device_data:
            state, m = mod.train_step_gather(state, pool_x, pool_y,
                                             batch[0], cfg=cfg, tx=tx)
        else:
            state, m = mod.train_step(state, *batch, cfg=cfg, tx=tx)
        step_h += 1
        logger.log_step(epoch, bi, spe, step_h, m, pts_per_step, n_chips)
        bi += 1
    return state, step_h


def _eval_epoch(cfg, epoch: int, epochs: int) -> bool:
    """``--eval_every K``: evaluate (and emit the epoch row / feed the
    checkpoint-selection metric) on every K-th epoch and ALWAYS on the
    final one. K=1 is the reference's eval-every-epoch. Non-eval epochs
    skip the epoch row entirely (the epoch CSV schema is fixed by its
    first row) and skip the save only under the ``best`` policy (which
    cannot rank an epoch it never measured)."""
    k = max(cfg.eval_every, 1)
    return (epoch + 1) % k == 0 or epoch == epochs - 1


def _skip_eval_epoch(cfg, saver, epoch, state):
    """Bookkeeping for a skipped-eval epoch (see ``_eval_epoch``)."""
    if cfg.ckpt_policy != "best":
        saver.save(cfg.out_dir, epoch, state)


def _fused_epoch_setup(cfg, n_test, spe):
    """Shared ``--fused_epoch`` preflight: validate the data mode and
    epoch plan, and build the fixed whole-test-pass eval plan
    (``[S, B]`` index rows + host validity mask, ``eval._eval_indices``
    protocol)."""
    if not cfg.fused_epoch:
        return None, None
    if not cfg.device_data:
        raise ValueError("--fused_epoch needs device-resident pools "
                         "(drop --host_data)")
    if cfg.eval_every > 1:
        raise ValueError(
            "--fused_epoch compiles the eval scan into every epoch's "
            "launch; --eval_every is a per-step-path knob (drop one)")
    if spe < 1:
        # The per-step path degrades to zero-step epochs; the fused
        # program scans a [spe, B] plan and cannot (np.stack of an
        # empty index list). Fail with the actual cause.
        raise ValueError(
            "--fused_epoch needs at least one full train batch per "
            f"epoch; the train pool is smaller than batch_size="
            f"{cfg.batch_size} (drop --fused_epoch or shrink the batch)")
    return eval_lib._eval_indices(n_test, cfg.batch_size)


def _fused_single_epoch(cfg, mod, state, tx, epoch, sharding, logger, spe,
                        pts_per_step, n_chips, step_h, pools, te_args,
                        te_idx_np):
    """One ``--fused_epoch`` epoch for a single-network trainer: the
    whole epoch plan ships as ONE ``[spe, B]`` index array and
    ``mod.epoch_program`` runs spe train steps + the eval scan in one
    compiled launch. Returns ``(state, step_h, eval_outs)``."""
    pool_x, pool_y, n = pools
    idx_np = np.stack(list(loader.host_index_iterator(
        n, cfg.batch_size, seed=cfg.seed, epoch=epoch)))
    (idx,) = loader._put((idx_np,), sharding, batch_axis=1)
    state, ms, ev_outs = mod.epoch_program(
        state, pool_x, pool_y, idx, te_args, te_idx_np, cfg=cfg, tx=tx)
    k = len(idx_np)
    step_h += k
    logger.log_scan_steps(epoch, 0, spe, step_h, ms, k, pts_per_step,
                          n_chips)
    return state, step_h, ev_outs


def run_classification(cfg: ClassifyConfig,
                       epochs: Optional[int] = None) -> dict:
    """Configs 1-2: mirrors ``upstream:train_classification.py``."""
    epochs = epochs if epochs is not None else cfg.epochs
    x_tr, y_tr, x_te, y_te = _modelnet_arrays(cfg)
    mesh, n_chips, sharding = _setup(cfg)
    spe = num_batches(len(x_tr), cfg.batch_size)
    tx = classify.make_tx(cfg, spe)
    state = classify.create_state(cfg, spe)
    if cfg.resume:
        state = (checkpoint.restore(cfg.resume, state) if cfg.resume_full
                 else checkpoint.load_params_only(cfg.resume, state))
    state = replicate_tree(mesh, state)
    logger = MetricLogger(cfg.out_dir, "cls", quiet=cfg.quiet, lag=cfg.log_lag)
    pts_per_step = cfg.batch_size * cfg.num_points
    best = 0.0
    pools = pool_te = None
    if cfg.device_data:
        pool_te = replicate_tree(mesh, x_te)
        pools = (*replicate_tree(mesh, (x_tr, y_tr)), len(y_tr))
    te_idx_np, te_mask = _fused_epoch_setup(cfg, len(y_te), spe)
    with jax.set_mesh(mesh), use_pallas(cfg.use_pallas), \
            mixed_precision(enabled=cfg.bf16), \
            maybe_trace(cfg.profile_dir), \
            checkpoint.AsyncSaver(cfg.ckpt_policy) as saver:
        step_h = int(state.step)  # one readback per run, not per launch
        for epoch in range(epochs):
            t0 = time.perf_counter()
            if cfg.fused_epoch:
                state, step_h, preds = _fused_single_epoch(
                    cfg, classify, state, tx, epoch, sharding, logger,
                    spe, pts_per_step, n_chips, step_h, pools,
                    (pool_te,), te_idx_np)
                t1 = time.perf_counter()
                ev = eval_lib.summarize_classifier_preds(
                    preds, y_te, te_mask, cfg.num_classes)
            else:
                state, step_h = _single_net_epoch(
                    cfg, classify, state, tx, epoch, sharding, logger, spe,
                    pts_per_step, n_chips, step_h, pools=pools,
                    arrays=(x_tr, y_tr))
                t1 = time.perf_counter()
                if not _eval_epoch(cfg, epoch, epochs):
                    _skip_eval_epoch(cfg, saver, epoch, state)
                    continue
                ev = (eval_lib.evaluate_classifier_device(
                          state.params, state.bn_state, pool_te, y_te,
                          cfg.batch_size, cfg.num_classes)
                      if cfg.device_data else
                      eval_lib.evaluate_classifier(
                          state.params, state.bn_state, x_te, y_te,
                          cfg.batch_size, cfg.num_classes))
            best = max(best, ev["accuracy"])
            t2 = time.perf_counter()
            saver.save(cfg.out_dir, epoch, state, metric=ev["accuracy"])
            logger.log_epoch(epoch, **ev, train_s=t1 - t0, eval_s=t2 - t1,
                             ckpt_s=time.perf_counter() - t2)
    logger.close()
    return {"best_accuracy": best, "state": state}


def run_segmentation(cfg: SegmentConfig, epochs: Optional[int] = None) -> dict:
    """Config 3: mirrors ``upstream:train_segmentation.py``."""
    epochs = epochs if epochs is not None else cfg.epochs
    (x_tr, s_tr, c_tr), (x_te, s_te, c_te) = _shapenet_arrays(cfg)
    mesh, n_chips, sharding = _setup(cfg)
    spe = num_batches(len(x_tr), cfg.batch_size)
    tx = segment.make_tx(cfg, spe)
    state = segment.create_state(cfg, spe)
    if cfg.resume:
        state = (checkpoint.restore(cfg.resume, state) if cfg.resume_full
                 else checkpoint.load_params_only(cfg.resume, state))
    state = replicate_tree(mesh, state)
    logger = MetricLogger(cfg.out_dir, "seg", quiet=cfg.quiet, lag=cfg.log_lag)
    pts_per_step = cfg.batch_size * cfg.num_points
    best = 0.0
    pools = pools_te = None
    if cfg.device_data:
        pools_te = replicate_tree(mesh, (x_te, s_te, c_te))
        pools = (*replicate_tree(mesh, (x_tr, s_tr)), len(s_tr))
    te_idx_np, te_mask = _fused_epoch_setup(cfg, len(s_te), spe)
    with jax.set_mesh(mesh), use_pallas(cfg.use_pallas), \
            mixed_precision(enabled=cfg.bf16), \
            maybe_trace(cfg.profile_dir), \
            checkpoint.AsyncSaver(cfg.ckpt_policy) as saver:
        step_h = int(state.step)  # one readback per run, not per launch
        for epoch in range(epochs):
            t0 = time.perf_counter()
            if cfg.fused_epoch:
                state, step_h, ev_outs = _fused_single_epoch(
                    cfg, segment, state, tx, epoch, sharding, logger,
                    spe, pts_per_step, n_chips, step_h, pools, pools_te,
                    te_idx_np)
                t1 = time.perf_counter()
                ev, table = eval_lib.summarize_segmenter_outs(
                    ev_outs, s_te, c_te, te_mask)
            else:
                state, step_h = _single_net_epoch(
                    cfg, segment, state, tx, epoch, sharding, logger, spe,
                    pts_per_step, n_chips, step_h, pools=pools,
                    arrays=(x_tr, s_tr))
                t1 = time.perf_counter()
                if not _eval_epoch(cfg, epoch, epochs):
                    _skip_eval_epoch(cfg, saver, epoch, state)
                    continue
                ev, table = (eval_lib.evaluate_segmenter_device(
                                 state.params, state.bn_state, *pools_te,
                                 s_te, c_te, cfg.batch_size)
                             if cfg.device_data else
                             eval_lib.evaluate_segmenter(
                                 state.params, state.bn_state, x_te, s_te,
                                 c_te, cfg.batch_size))
            best = max(best, ev["instance_miou"])
            t2 = time.perf_counter()
            saver.save(cfg.out_dir, epoch, state,
                       metric=ev["instance_miou"])
            logger.log_epoch(epoch, **ev, train_s=t1 - t0, eval_s=t2 - t1,
                             ckpt_s=time.perf_counter() - t2)
    logger.close()
    return {"best_miou": best, "state": state, "category_miou": table}


def run_adversarial(cfg: AdversarialConfig,
                    epochs: Optional[int] = None) -> dict:
    """Config 4: mirrors ``upstream:train_adversarial*.py`` — labeled/
    unlabeled split by ``labeled_ratio``, alternating G/D single-jit
    updates, semi-supervised masked loss.

    Stream semantics follow the reference: one pass over the LABELED split
    defines an epoch; the unlabeled stream shuffles and cycles
    independently, its position persisting across epochs (the reference's
    iterator-reset-on-StopIteration pattern). With ``cfg.scan = K > 1``,
    K steps fuse into one ``lax.scan`` program fed by K-batch stacked
    host transfers.
    """
    epochs = epochs if epochs is not None else cfg.epochs
    (x_tr, s_tr, c_tr), (x_te, s_te, c_te) = _shapenet_arrays(cfg)
    n_lab = max(int(len(x_tr) * cfg.labeled_ratio), cfg.batch_size)
    mesh, n_chips, sharding = _setup(cfg)
    spe = max(num_batches(n_lab, cfg.batch_size), 1)
    g_tx, d_tx = adversarial.make_txs(cfg, spe)
    state = adversarial.create_state(cfg, spe)
    if cfg.resume:
        state = (checkpoint.restore(cfg.resume, state) if cfg.resume_full
                 else checkpoint.load_params_only(cfg.resume, state))
    state = replicate_tree(mesh, state)
    logger = MetricLogger(cfg.out_dir, "adv", quiet=cfg.quiet, lag=cfg.log_lag)
    pts_per_step = 2 * cfg.batch_size * cfg.num_points
    best = 0.0
    x_unl = x_tr[n_lab:]
    if len(x_unl) < cfg.batch_size:
        print(f"[runner] WARNING: labeled_ratio={cfg.labeled_ratio} leaves "
              f"{len(x_unl)} unlabeled shapes (<1 batch); cycling the full "
              "train set (labeled included) as the unlabeled stream",
              file=sys.stderr)
        x_unl = x_tr
    # Infinite unlabeled stream, created ONCE (position persists across
    # epochs, like the reference's cycled iterator). On the (default)
    # device-data path the pools are staged in HBM once and both streams
    # carry only [B] int32 index vectors — the batch gather (the
    # reference ``__getitem__`` row selection) runs inside the jitted
    # step; index streams reproduce the host streams' permutations
    # exactly (loader.host_index_iterator).
    pools_te = None
    if cfg.device_data:
        pool_x = replicate_tree(mesh, x_tr[:n_lab])
        pool_y = replicate_tree(mesh, s_tr[:n_lab])
        pool_u = replicate_tree(mesh, x_unl)
        pools_te = replicate_tree(mesh, (x_te, s_te, c_te))
        unl_idx_stream = loader.cycling_host_indices(
            len(x_unl), cfg.batch_size, seed=cfg.seed + 1)
    else:
        unl_stream = loader.cycling_host_batches((x_unl,), cfg.batch_size,
                                                 seed=cfg.seed + 1)
    table: dict = {}
    te_idx_np, te_mask = _fused_epoch_setup(cfg, len(s_te), spe)
    with jax.set_mesh(mesh), use_pallas(cfg.use_pallas), \
            mixed_precision(enabled=cfg.bf16), \
            maybe_trace(cfg.profile_dir), \
            checkpoint.AsyncSaver(cfg.ckpt_policy) as saver:
        step_h = int(state.step)  # one readback per run, not per launch
        for epoch in range(epochs):
            t0 = time.perf_counter()
            if cfg.fused_epoch:
                # ONE launch per epoch: spe G+D steps + the eval scan
                # (adversarial.epoch_program). One readback group drains
                # the [K] train metrics and the [S, B] eval reductions.
                idx_l_np = np.stack(list(loader.host_index_iterator(
                    n_lab, cfg.batch_size, seed=cfg.seed, epoch=epoch)))
                idx_u_np = np.stack([next(unl_idx_stream)
                                     for _ in range(len(idx_l_np))])
                idx_l, idx_u = loader._put((idx_l_np, idx_u_np), sharding,
                                           batch_axis=1)
                state, ms, ev_outs = adversarial.epoch_program(
                    state, pool_x, pool_y, pool_u, idx_l, idx_u,
                    *pools_te, te_idx_np, cfg=cfg, g_tx=g_tx, d_tx=d_tx)
                k = len(idx_l_np)
                step_h += k
                logger.log_scan_steps(epoch, 0, spe, step_h, ms, k,
                                      pts_per_step, n_chips)
                t1 = time.perf_counter()
                ev, table = eval_lib.summarize_segmenter_outs(
                    ev_outs, s_te, c_te, te_mask)
                best = max(best, ev["instance_miou"])
                t2 = time.perf_counter()
                saver.save(cfg.out_dir, epoch, state,
                           metric=ev["instance_miou"])
                t3 = time.perf_counter()
                logger.log_epoch(epoch, **ev, train_s=t1 - t0,
                                 eval_s=t2 - t1, ckpt_s=t3 - t2)
                continue
            if cfg.device_data:
                lab_idx = loader.host_index_iterator(
                    n_lab, cfg.batch_size, seed=cfg.seed, epoch=epoch)
                paired = zip(lab_idx, unl_idx_stream)
            else:
                lab_host = loader.host_batch_iterator(
                    (x_tr[:n_lab], s_tr[:n_lab]), cfg.batch_size,
                    seed=cfg.seed, epoch=epoch)
                paired = ((xl, yl, xu) for (xl, yl), (xu,)
                          in zip(lab_host, unl_stream))
            bi = 0
            for batch, stacked in loader.device_batches(
                    paired, sharding, k_stack=cfg.scan,
                    prefetch=_prefetch_depth(cfg)):
                if cfg.device_data:
                    i_l, i_u = batch
                    if stacked:
                        state, ms = adversarial.train_steps_scan_gather(
                            state, pool_x, pool_y, pool_u, i_l, i_u,
                            cfg=cfg, g_tx=g_tx, d_tx=d_tx)
                    else:
                        state, m = adversarial.train_step_gather(
                            state, pool_x, pool_y, pool_u, i_l, i_u,
                            cfg=cfg, g_tx=g_tx, d_tx=d_tx)
                elif stacked:
                    state, ms = adversarial.train_steps_scan(
                        state, *batch, cfg=cfg, g_tx=g_tx, d_tx=d_tx)
                else:
                    state, m = adversarial.train_step(
                        state, *batch, cfg=cfg, g_tx=g_tx, d_tx=d_tx)
                if stacked:
                    k = batch[0].shape[0]
                    step_h += k
                    logger.log_scan_steps(epoch, bi, spe, step_h, ms, k,
                                          pts_per_step, n_chips)
                    bi += k
                else:
                    step_h += 1
                    logger.log_step(epoch, bi, spe, step_h, m,
                                    pts_per_step, n_chips)
                    bi += 1
            t1 = time.perf_counter()
            if not _eval_epoch(cfg, epoch, epochs):
                _skip_eval_epoch(cfg, saver, epoch, state)
                continue
            ev, table = (eval_lib.evaluate_segmenter_device(
                             state.g_params, state.g_bn_state, *pools_te,
                             s_te, c_te, cfg.batch_size)
                         if cfg.device_data else
                         eval_lib.evaluate_segmenter(
                             state.g_params, state.g_bn_state, x_te, s_te,
                             c_te, cfg.batch_size))
            best = max(best, ev["instance_miou"])
            t2 = time.perf_counter()
            saver.save(cfg.out_dir, epoch, state,
                       metric=ev["instance_miou"])
            t3 = time.perf_counter()
            logger.log_epoch(epoch, **ev, train_s=t1 - t0, eval_s=t2 - t1,
                             ckpt_s=t3 - t2)
    logger.close()
    return {"best_miou": best, "state": state, "category_miou": table}


def run_adv_perturb(cfg: AdvPerturbConfig,
                    epochs: Optional[int] = None) -> dict:
    """Config 5: FGSM perturbation training (+ DP, same mesh plumbing)."""
    epochs = epochs if epochs is not None else cfg.epochs
    x_tr, y_tr, x_te, y_te = _modelnet_arrays(cfg)
    mesh, n_chips, sharding = _setup(cfg)
    spe = num_batches(len(x_tr), cfg.batch_size)
    tx = adv_perturb.make_tx(cfg, spe)
    state = adv_perturb.create_state(cfg, spe)
    if cfg.resume:
        state = (checkpoint.restore(cfg.resume, state) if cfg.resume_full
                 else checkpoint.load_params_only(cfg.resume, state))
    state = replicate_tree(mesh, state)
    logger = MetricLogger(cfg.out_dir, "advp", quiet=cfg.quiet, lag=cfg.log_lag)
    pts_per_step = cfg.batch_size * cfg.num_points
    best = 0.0
    pools = pool_te = None
    if cfg.device_data:
        pool_te = replicate_tree(mesh, x_te)
        pools = (*replicate_tree(mesh, (x_tr, y_tr)), len(y_tr))
    te_idx_np, te_mask = _fused_epoch_setup(cfg, len(y_te), spe)
    with jax.set_mesh(mesh), use_pallas(cfg.use_pallas), \
            mixed_precision(enabled=cfg.bf16), \
            maybe_trace(cfg.profile_dir), \
            checkpoint.AsyncSaver(cfg.ckpt_policy) as saver:
        step_h = int(state.step)  # one readback per run, not per launch
        for epoch in range(epochs):
            t0 = time.perf_counter()
            if cfg.fused_epoch:
                state, step_h, preds = _fused_single_epoch(
                    cfg, adv_perturb, state, tx, epoch, sharding, logger,
                    spe, pts_per_step, n_chips, step_h, pools,
                    (pool_te,), te_idx_np)
                t1 = time.perf_counter()
                ev = eval_lib.summarize_classifier_preds(
                    preds, y_te, te_mask, cfg.num_classes)
            else:
                state, step_h = _single_net_epoch(
                    cfg, adv_perturb, state, tx, epoch, sharding, logger,
                    spe, pts_per_step, n_chips, step_h, pools=pools,
                    arrays=(x_tr, y_tr))
                t1 = time.perf_counter()
                if not _eval_epoch(cfg, epoch, epochs):
                    _skip_eval_epoch(cfg, saver, epoch, state)
                    continue
                ev = (eval_lib.evaluate_classifier_device(
                          state.params, state.bn_state, pool_te, y_te,
                          cfg.batch_size, cfg.num_classes)
                      if cfg.device_data else
                      eval_lib.evaluate_classifier(
                          state.params, state.bn_state, x_te, y_te,
                          cfg.batch_size, cfg.num_classes))
            best = max(best, ev["accuracy"])
            t2 = time.perf_counter()
            saver.save(cfg.out_dir, epoch, state, metric=ev["accuracy"])
            logger.log_epoch(epoch, **ev, train_s=t1 - t0, eval_s=t2 - t1,
                             ckpt_s=time.perf_counter() - t2)
    logger.close()
    return {"best_accuracy": best, "state": state}
