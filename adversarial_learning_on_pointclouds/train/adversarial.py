"""Config 4: adversarial semi-supervised segmentation (``BASELINE.json:10``).

Rebuild of the reference's alternating G/D loop
(``upstream:train_adversarial*.py``; SURVEY.md §2.6, call stack §3.3),
following Hung et al. arXiv:1802.07934. Per iteration the reference runs
two sequential backward/step passes:

1. **G step** (D frozen): ``L_G = L_ce(pred_l, y_l)
   + lambda_adv * BCE(D(softmax(pred)), REAL)
   + lambda_semi * L_semi(pred_u, D(softmax(pred_u)))``.
2. **D step** (G detached): ``L_D = BCE(D(one_hot(y_l)), REAL)
   + BCE(D(softmax(pred)).detach, FAKE)``.

Here both gradient computations and both optax updates compile into ONE
jitted ``train_step`` (``BASELINE.json:5`` "single jitted update"):
freezing D during the G step falls out of differentiating only w.r.t.
``g_params``; detaching G during the D step is a ``stop_gradient`` on the
predicted probability maps, which are *reused* from the G-step forward
(the reference recomputes nothing either — it calls ``.detach()`` on the
same tensors). Under DP both grad trees allreduce inside the same XLA
program.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from adversarial_learning_on_pointclouds import losses
from adversarial_learning_on_pointclouds.configs import AdversarialConfig
from adversarial_learning_on_pointclouds.data import augment
from adversarial_learning_on_pointclouds.models import (
    apply_discriminator, apply_segmenter, init_discriminator, init_segmenter,
)
from adversarial_learning_on_pointclouds.train import state as state_lib
from adversarial_learning_on_pointclouds.train.classify import FT_REG_WEIGHT


def create_state(cfg: AdversarialConfig, steps_per_epoch: int,
                 rng: Optional[jax.Array] = None) -> state_lib.GANTrainState:
    assert not (cfg.supervised_only and cfg.self_training), (
        "--supervised_only and --self_training are mutually exclusive "
        "ablation controls")
    rng = jax.random.PRNGKey(cfg.seed) if rng is None else rng
    kg, kd, k_run = jax.random.split(rng, 3)
    g_params, g_bn = init_segmenter(kg, cfg.num_parts, cfg.feature_transform,
                                    dtype=jnp.dtype(cfg.dtype))
    # --d_geometry widens the D input by the 3 coordinate channels.
    d_params = init_discriminator(
        kd, cfg.num_parts + (3 if cfg.d_geometry else 0),
        dtype=jnp.dtype(cfg.dtype))
    g_tx, d_tx = make_txs(cfg, steps_per_epoch)
    return state_lib.GANTrainState(
        g_params=g_params, g_bn_state=g_bn, g_opt_state=g_tx.init(g_params),
        d_params=d_params, d_opt_state=d_tx.init(d_params),
        step=jnp.zeros((), jnp.int32), rng=k_run)


def make_txs(cfg: AdversarialConfig, steps_per_epoch: int):
    """G and D optimizers. ``cfg.optimizer``/``cfg.lr_schedule`` select
    between the reference-lineage default (Adam + StepLR for both) and the
    Hung et al. original (SGD-G / Adam-D with poly decay) — the D stays
    Adam in both, as in Hung et al."""
    total = cfg.epochs * steps_per_epoch
    g_tx = state_lib.make_optimizer(
        cfg.lr, cfg.beta1, cfg.beta2, cfg.lr_step, cfg.lr_gamma,
        steps_per_epoch, optimizer=cfg.optimizer,
        lr_schedule=cfg.lr_schedule, total_steps=total,
        poly_power=cfg.poly_power)
    d_tx = state_lib.make_optimizer(
        cfg.lr_d, cfg.beta1_d, cfg.beta2_d, cfg.lr_step, cfg.lr_gamma,
        steps_per_epoch, optimizer="adam",
        lr_schedule=cfg.lr_schedule, total_steps=total,
        poly_power=cfg.poly_power)
    return g_tx, d_tx



def _d_in(probs, xyz, on: bool):
    """The D's input map: per-point class probabilities, plus — under the
    ``--d_geometry`` EXTENSION — the (augmented) xyz coordinates on the
    channel axis (``[B, N, k+3]``). The reference's pointwise D sees
    probabilities only, which reduces its prior to per-point marginal
    shape (docs/ADVERSARIAL_GAIN.md); coordinates let it
    judge label-geometry consistency. The coordinates are G-independent
    inputs, so gradient routing through ``probs`` is unchanged."""
    if not on:
        return probs
    return jnp.concatenate([probs, xyz.astype(probs.dtype)], axis=-1)


def _g_loss_fn(g_params, d_params, g_bn, x_l, y_l, x_u,
               cfg: AdversarialConfig, semi_on: jnp.ndarray):
    """Generator objective; returns aux needed for the D step."""
    # Two train-mode forwards, BN running stats chained in call order
    # (labeled first), matching the reference's sequential module calls.
    # --remat recomputes the segmenter's big per-point intermediates in
    # backward instead of saving them: a memory knob for much larger
    # batch/point counts, off by default.
    def seg_train(p, s, x):
        return apply_segmenter(p, s, x, train=True)

    if cfg.remat:
        seg_train = jax.checkpoint(seg_train)

    if cfg.supervised_only:
        # Ablation baseline (--supervised_only): CE on the SAME labeled
        # subset through the SAME pipeline, nothing else — no unlabeled
        # forward, no D forward, no adv/semi terms. This is the config-3
        # control for the adversarial-gain comparison (Hung et al. table
        # 1 reads adv+semi against exactly this baseline at each
        # labeled_ratio).
        logp_l, _, tf_l, bn1 = seg_train(g_params, g_bn, x_l)
        l_ce = losses.nll_loss(logp_l, y_l)
        if cfg.feature_transform:
            l_ce = l_ce + FT_REG_WEIGHT * losses.orthogonality_reg(tf_l)
        zero = jnp.zeros((), logp_l.dtype)
        aux = dict(bn=bn1, l_ce=l_ce, l_adv=zero, l_semi=zero,
                   logp_l=logp_l)
        return l_ce, aux

    # --self_training skips every D forward but keeps the stream
    # forwards (and the ortho reg over both transforms) IDENTICAL to
    # the adversarial path, so the st-vs-adv comparison isolates the
    # mask source (G confidence vs D confidence) and the adv term.
    need_d = not cfg.self_training
    b = x_l.shape[0]
    if cfg.fused_forward:
        # One combined G forward+backward and one combined D pass over
        # [x_l ; x_u] instead of two of each (opt-in). Semantics delta
        # vs. the reference's sequential calls:
        # BN batch statistics cover the combined 2B batch in one update;
        # the ortho regularizer is scaled to keep the loss identical.
        xb = jnp.concatenate([x_l, x_u], axis=0)
        logp, _, tf_b, bn2 = seg_train(g_params, g_bn, xb)
        logp_l, logp_u = logp[:b], logp[b:]
        probs = jnp.exp(logp)  # softmax(G(x)) — logp is log_softmax
        probs_l, probs_u = probs[:b], probs[b:]
        if need_d:
            d_out = apply_discriminator(d_params, _d_in(probs, xb, cfg.d_geometry))
            d_out_l, d_out_u = d_out[:b], d_out[b:]
        reg = (2.0 * losses.orthogonality_reg(tf_b)
               if tf_b is not None else 0.0)
    elif cfg.paired_heads:
        # Cross-stream-batched T-Net fc heads (the [B,1024]-row latency
        # hot spot); conv trunks, stashes and their BN stats stay
        # per-stream — see models.segmenter.apply_segmenter_pair.
        from adversarial_learning_on_pointclouds.models import (
            segmenter as _seg,
        )

        def seg_pair(p, s, xa, xb):
            return _seg.apply_segmenter_pair(p, s, xa, xb,
                                             cfg.paired_conv1)

        if cfg.remat:
            seg_pair = jax.checkpoint(seg_pair)
        logp_l, logp_u, tf_l, tf_u, bn2 = seg_pair(g_params, g_bn, x_l,
                                                   x_u)
        probs_l = jnp.exp(logp_l)
        probs_u = jnp.exp(logp_u)
        if need_d:
            d_out_l = apply_discriminator(d_params,
                                _d_in(probs_l, x_l, cfg.d_geometry))
            d_out_u = apply_discriminator(d_params,
                                _d_in(probs_u, x_u, cfg.d_geometry))
        reg = (losses.orthogonality_reg(tf_l)
               + losses.orthogonality_reg(tf_u))
    else:
        logp_l, _, tf_l, bn1 = seg_train(g_params, g_bn, x_l)
        logp_u, _, tf_u, bn2 = seg_train(g_params, bn1, x_u)
        probs_l = jnp.exp(logp_l)
        probs_u = jnp.exp(logp_u)
        if need_d:
            d_out_l = apply_discriminator(d_params,
                                _d_in(probs_l, x_l, cfg.d_geometry))
            d_out_u = apply_discriminator(d_params,
                                _d_in(probs_u, x_u, cfg.d_geometry))
        reg = (losses.orthogonality_reg(tf_l)
               + losses.orthogonality_reg(tf_u))

    l_ce = losses.nll_loss(logp_l, y_l)
    if cfg.feature_transform:
        l_ce = l_ce + FT_REG_WEIGHT * reg
    if cfg.self_training:
        l_semi = losses.self_train_loss(logp_u, cfg.semi_threshold)
        total = l_ce + semi_on * cfg.lambda_semi * l_semi
        zero = jnp.zeros((), logp_l.dtype)
        aux = dict(bn=bn2, l_ce=l_ce, l_adv=zero, l_semi=l_semi,
                   logp_l=logp_l)
        return total, aux
    adv_l = losses.adv_g_loss(d_out_l)
    adv_u = losses.adv_g_loss(d_out_u)
    l_adv = 0.5 * (adv_l + adv_u)
    if cfg.lambda_adv_unl is None:
        # Default: one lambda_adv averaged over both streams.
        adv_term = cfg.lambda_adv * l_adv
    else:
        # Hung et al. per-stream eq. 3: separate weights on the labeled
        # and unlabeled adversarial terms (e.g. 0.01 / 0.001).
        adv_term = cfg.lambda_adv * adv_l + cfg.lambda_adv_unl * adv_u
    l_semi = losses.semi_loss(logp_u, d_out_u, cfg.semi_threshold)
    total = l_ce + adv_term + semi_on * cfg.lambda_semi * l_semi
    aux = dict(bn=bn2, probs_l=probs_l, probs_u=probs_u,
               d_l=d_out_l, d_u=d_out_u,
               l_ce=l_ce, l_adv=l_adv, l_semi=l_semi, logp_l=logp_l)
    return total, aux


def _d_loss_fn(d_params, probs_l, probs_u, y_l, num_parts: int,
               xyz=None):
    """Discriminator objective on detached G outputs + one-hot GT.

    Single D pass over [fake_l ; fake_u ; real] — the pointwise D has no
    cross-example interaction, so batching the three maps is exact.
    """
    b = probs_l.shape[0]
    real = jax.nn.one_hot(y_l, num_parts, dtype=probs_l.dtype)
    if xyz is not None:
        # --d_geometry: same coordinate channels on fakes AND reals (the
        # labeled stream's coordinates ride the one-hot GT map).
        xl, xu = xyz
        probs_l = _d_in(probs_l, xl, True)
        probs_u = _d_in(probs_u, xu, True)
        real = _d_in(real, xl, True)
    stacked = jnp.concatenate([probs_l, probs_u, real], axis=0)
    d_all = apply_discriminator(d_params, stacked)
    d_fake, d_real = d_all[:2 * b], d_all[2 * b:]
    return losses.d_loss(d_real, d_fake), (d_real, d_fake)


@functools.partial(jax.jit, static_argnames=("cfg", "g_tx", "d_tx", "paths"))
def _train_step_jit(state, x_l, y_l, x_u, *, cfg, g_tx, d_tx, paths):
    from adversarial_learning_on_pointclouds.ops import dispatch
    with dispatch.path_context(paths):
        return _train_step_impl(state, x_l, y_l, x_u, cfg, g_tx, d_tx)


def train_step(state: state_lib.GANTrainState,
               x_l: jnp.ndarray, y_l: jnp.ndarray, x_u: jnp.ndarray, *,
               cfg: AdversarialConfig, g_tx, d_tx,
               ) -> Tuple[state_lib.GANTrainState, Dict[str, jnp.ndarray]]:
    """One alternating G/D update as a single XLA program.

    ``x_l [B,N_src,3]`` labeled points, ``y_l [B,N_src]`` part labels,
    ``x_u [B,N_src,3]`` unlabeled points (resampled on device to
    ``cfg.num_points``). Kernel-route/bf16 flags are jit-cache-keyed
    (``dispatch.current_paths``, see classify.train_step).
    """
    from adversarial_learning_on_pointclouds.ops import dispatch
    return _train_step_jit(state, x_l, y_l, x_u, cfg=cfg, g_tx=g_tx,
                           d_tx=d_tx, paths=dispatch.current_paths())


@functools.partial(jax.jit, static_argnames=("cfg", "g_tx", "d_tx", "paths"))
def _train_steps_scan_jit(state, x_l, y_l, x_u, *, cfg, g_tx, d_tx, paths):
    from adversarial_learning_on_pointclouds.ops import dispatch

    def body(s, batch):
        xl, yl, xu = batch
        s, m = _train_step_impl(s, xl, yl, xu, cfg, g_tx, d_tx)
        return s, m

    with dispatch.path_context(paths):
        return jax.lax.scan(body, state, (x_l, y_l, x_u))


def train_steps_scan(state: state_lib.GANTrainState,
                     x_l: jnp.ndarray, y_l: jnp.ndarray, x_u: jnp.ndarray, *,
                     cfg: AdversarialConfig, g_tx, d_tx,
                     ) -> Tuple[state_lib.GANTrainState,
                                Dict[str, jnp.ndarray]]:
    """K alternating G/D updates in ONE compiled program via ``lax.scan``.

    Inputs carry a leading K axis (``x_l [K,B,N_src,3]`` ...). Amortizes
    the per-step host dispatch over K steps. Returns
    per-step metrics stacked along K. Driven by the runner's ``--scan K``
    with K-batch stacked prefetch (``data/loader.py::device_batches``).
    """
    from adversarial_learning_on_pointclouds.ops import dispatch
    return _train_steps_scan_jit(state, x_l, y_l, x_u, cfg=cfg, g_tx=g_tx,
                                 d_tx=d_tx, paths=dispatch.current_paths())


@functools.partial(jax.jit, static_argnames=("cfg", "g_tx", "d_tx", "paths"))
def _train_step_gather_jit(state, pool_x, pool_y, pool_u, idx_l, idx_u, *,
                           cfg, g_tx, d_tx, paths):
    from adversarial_learning_on_pointclouds.ops import dispatch
    with dispatch.path_context(paths):
        x_l = jnp.take(pool_x, idx_l, axis=0)
        y_l = jnp.take(pool_y, idx_l, axis=0)
        x_u = jnp.take(pool_u, idx_u, axis=0)
        return _train_step_impl(state, x_l, y_l, x_u, cfg, g_tx, d_tx)


def train_step_gather(state: state_lib.GANTrainState,
                      pool_x: jnp.ndarray, pool_y: jnp.ndarray,
                      pool_u: jnp.ndarray, idx_l: jnp.ndarray,
                      idx_u: jnp.ndarray, *, cfg: AdversarialConfig,
                      g_tx, d_tx) -> Tuple[state_lib.GANTrainState,
                                           Dict[str, jnp.ndarray]]:
    """``train_step`` with device-resident data pools.

    The host transfers only the ``[B]`` int32 index vectors per step; the
    batch gather (the reference Dataset's ``__getitem__`` row selection)
    runs on device from pools staged in HBM once per run. Identical
    numerics to ``train_step`` on the gathered rows — the runner's
    default when the train pools fit in device memory (they always do at
    this model's dataset scale; ModelNet40 is ~242 MB)."""
    from adversarial_learning_on_pointclouds.ops import dispatch
    return _train_step_gather_jit(state, pool_x, pool_y, pool_u, idx_l,
                                  idx_u, cfg=cfg, g_tx=g_tx, d_tx=d_tx,
                                  paths=dispatch.current_paths())


@functools.partial(jax.jit, static_argnames=("cfg", "g_tx", "d_tx", "paths"))
def _train_steps_scan_gather_jit(state, pool_x, pool_y, pool_u, idx_l,
                                 idx_u, *, cfg, g_tx, d_tx, paths):
    from adversarial_learning_on_pointclouds.ops import dispatch

    def body(s, idxs):
        il, iu = idxs
        return _train_step_impl(
            s, jnp.take(pool_x, il, axis=0), jnp.take(pool_y, il, axis=0),
            jnp.take(pool_u, iu, axis=0), cfg, g_tx, d_tx)

    with dispatch.path_context(paths):
        return jax.lax.scan(body, state, (idx_l, idx_u))


@functools.partial(jax.jit, static_argnames=("cfg", "g_tx", "d_tx", "paths"))
def _epoch_program_jit(state, pool_x, pool_y, pool_u, idx_l, idx_u,
                       te_x, te_s, te_c, te_idx, *, cfg, g_tx, d_tx, paths):
    from adversarial_learning_on_pointclouds.ops import dispatch
    from adversarial_learning_on_pointclouds.train import segment

    with dispatch.path_context(paths):
        def body(s, idxs):
            il, iu = idxs
            return _train_step_impl(
                s, jnp.take(pool_x, il, axis=0),
                jnp.take(pool_y, il, axis=0),
                jnp.take(pool_u, iu, axis=0), cfg, g_tx, d_tx)

        state, ms = jax.lax.scan(body, state, (idx_l, idx_u))
        ev = segment.eval_scan_inner(state.g_params, state.g_bn_state,
                                     te_x, te_s, te_c, te_idx)
        return state, ms, ev


def epoch_program(state: state_lib.GANTrainState, pool_x, pool_y, pool_u,
                  idx_l: jnp.ndarray, idx_u: jnp.ndarray,
                  te_x, te_s, te_c, te_idx: jnp.ndarray, *,
                  cfg: AdversarialConfig, g_tx, d_tx):
    """A FULL epoch — ``spe`` G+D steps AND the whole-test-set eval scan —
    as ONE compiled program (``--fused_epoch``, VERDICT r2 next #3).

    Fusing the eval scan behind the train scan in the SAME program
    removes the separate eval dispatch and lets one readback group drain
    both the [K] train metrics and the [S, B] eval reductions. ``idx_l``/``idx_u`` are
    ``[spe, B]`` int32 epoch plans; ``te_idx`` the ``[S, B]`` eval plan
    (same protocol as ``eval.evaluate_segmenter_device``)."""
    from adversarial_learning_on_pointclouds.ops import dispatch
    return _epoch_program_jit(state, pool_x, pool_y, pool_u, idx_l, idx_u,
                              te_x, te_s, te_c, te_idx, cfg=cfg, g_tx=g_tx,
                              d_tx=d_tx, paths=dispatch.current_paths())


def train_steps_scan_gather(state: state_lib.GANTrainState,
                            pool_x: jnp.ndarray, pool_y: jnp.ndarray,
                            pool_u: jnp.ndarray, idx_l: jnp.ndarray,
                            idx_u: jnp.ndarray, *, cfg: AdversarialConfig,
                            g_tx, d_tx) -> Tuple[state_lib.GANTrainState,
                                                 Dict[str, jnp.ndarray]]:
    """K fused steps per launch from device-resident pools; ``idx_l`` /
    ``idx_u`` carry a leading K axis (``[K, B]`` int32)."""
    from adversarial_learning_on_pointclouds.ops import dispatch
    return _train_steps_scan_gather_jit(state, pool_x, pool_y, pool_u,
                                        idx_l, idx_u, cfg=cfg, g_tx=g_tx,
                                        d_tx=d_tx,
                                        paths=dispatch.current_paths())


def _train_step_impl(state, x_l, y_l, x_u, cfg, g_tx, d_tx):
    rng, k_aug_l, k_aug_u = jax.random.split(state.rng, 3)
    # Fused preprocessing chain (normalize -> resample -> rotate -> jitter
    # -> dropout), per-stream keys; labeled part labels ride the resample.
    x_l, y_l = augment.chain_from_cfg(k_aug_l, cfg, x_l, y_l)
    x_u = augment.chain_from_cfg(k_aug_u, cfg, x_u)

    semi_on = (state.step >= cfg.semi_start).astype(jnp.float32)

    # --- G step: differentiate w.r.t. g_params only (D frozen). ---
    (g_loss, aux), g_grads = jax.value_and_grad(_g_loss_fn, has_aux=True)(
        state.g_params, state.d_params, state.g_bn_state, x_l, y_l, x_u,
        cfg, semi_on)
    g_updates, new_g_opt = g_tx.update(g_grads, state.g_opt_state,
                                       state.g_params)
    new_g_params = jax.tree_util.tree_map(
        lambda p, u: p + u, state.g_params, g_updates)

    if cfg.supervised_only or cfg.self_training:
        # Ablation controls: no D update (and no D compute anywhere —
        # the G loss above never forwarded it).
        new_d_params, new_d_opt = state.d_params, state.d_opt_state
        d_loss_v = jnp.zeros((), g_loss.dtype)
    else:
        # --- D step: G outputs detached (reference's ``.detach()``). ---
        probs_l = jax.lax.stop_gradient(aux["probs_l"])
        probs_u = jax.lax.stop_gradient(aux["probs_u"])
        xyz = ((jax.lax.stop_gradient(x_l), jax.lax.stop_gradient(x_u))
               if cfg.d_geometry else None)
        (d_loss_v, _), d_grads = jax.value_and_grad(
            _d_loss_fn, has_aux=True)(
                state.d_params, probs_l, probs_u, y_l, cfg.num_parts, xyz)
        d_updates, new_d_opt = d_tx.update(d_grads, state.d_opt_state,
                                           state.d_params)
        new_d_params = jax.tree_util.tree_map(
            lambda p, u: p + u, state.d_params, d_updates)

    acc = jnp.mean(jnp.argmax(aux["logp_l"], -1) == y_l)
    new_state = state_lib.GANTrainState(
        g_params=new_g_params, g_bn_state=aux["bn"], g_opt_state=new_g_opt,
        d_params=new_d_params, d_opt_state=new_d_opt,
        step=state.step + 1, rng=rng)
    metrics = {"loss_g": g_loss, "loss_ce": aux["l_ce"],
               "loss_adv": aux["l_adv"], "loss_semi": aux["l_semi"],
               "loss_d": d_loss_v, "acc": acc}
    return new_state, metrics
