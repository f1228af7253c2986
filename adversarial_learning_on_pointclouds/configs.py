"""Frozen dataclass configs for the five baseline configurations.

Mirrors the reference's per-script argparse surface (flag names like
``--batchSize``, ``--num_points``, ``--nepoch``, ``--outf``, ``--model``,
``--feature_transform``, ``--lambda_adv``, ``--lambda_semi``,
``--threshold`` — reference: ``upstream:train_*.py`` argparse blocks, see
SURVEY.md §2.10/§5) while keeping a single typed config object internally.

The five configs correspond to ``BASELINE.json:7-11``:

1. ``ClassifyConfig``           — PointNet classifier, ModelNet40 1024 pts,
   batch 32, cross-entropy only (CPU-runnable).
2. ``ClassifyConfig(feature_transform=True, augment=True)`` — + T-Net
   feature-transform regularizer, on-device jitter/rotate augmentation.
3. ``SegmentConfig``            — part-segmentation generator on
   ShapeNet-part (2048 pts, per-point logits).
4. ``AdversarialConfig``        — generator + FCN discriminator,
   alternating G/D updates, semi-supervised loss.
5. ``AdvPerturbConfig``         — FGSM-style point jitter attack training
   + multi-chip DP.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    """Options shared by every training configuration."""

    batch_size: int = 32          # --batchSize  (reference default 32)
    num_points: int = 1024        # --num_points
    epochs: int = 250             # --nepoch
    out_dir: str = "cls"          # --outf
    resume: Optional[str] = None  # --model (checkpoint to warm-start from)
    resume_full: bool = False     # --resume_full (full-state resume, not
                                  #   just params: optimizer, RNG, step)
    dataset: str = ""             # --dataset (data root; '' -> synthetic)
    seed: int = 0                 # --manualSeed
    lr: float = 1e-3              # Adam lr (pointnet.pytorch default)
    beta1: float = 0.9
    beta2: float = 0.999
    lr_step: int = 20             # StepLR step_size
    lr_gamma: float = 0.5         # StepLR gamma
    optimizer: str = "adam"       # --optimizer {adam,sgd}: sgd(momentum
                                  #   0.9) is the Hung et al. G-optimizer
    lr_schedule: str = "step"     # --lr_schedule {step,poly}: poly is the
                                  #   Hung et al. (1-step/total)^0.9 decay
    poly_power: float = 0.9       # --poly_power
    feature_transform: bool = False  # --feature_transform
    augment: bool = False         # on-device rotate/jitter chain
    normalize: bool = True        # unit-sphere normalize (reference
                                  #   __getitem__ does this for every
                                  #   shape); --no_normalize to disable
    resample: bool = True         # fresh fixed-N subsample per batch on
                                  #   device when the source clouds have
                                  #   more points than num_points
                                  #   (reference: np.random.choice per
                                  #   __getitem__); --no_resample freezes
                                  #   one host-side subsample per run
    point_dropout: bool = False   # --point_dropout (provider.py
                                  #   random_point_dropout, max ratio .875)
    scan: int = 0                 # --scan K: fuse K train steps per
                                  #   program launch via lax.scan with
                                  #   K-batch stacked transfers
    use_pallas: bool = True       # allow the trunk-exit kernel on a GPU
                                  #   (ops/dispatch.py); --no_pallas
                                  #   forces the plain XLA path
    bf16: bool = False            # mixed precision: bf16 matmul inputs
    remat: bool = False           # rematerialize big per-point
                                  #   activations in backward (HBM win)
    dtype: str = "float32"        # compute dtype for the model
    num_devices: int = 0          # 0 -> all visible devices (DP mesh)
    profile_dir: Optional[str] = None  # --profile_dir (jax.profiler trace)
    quiet: bool = False           # --quiet (stdout parity mode)
    ckpt_policy: str = "every"    # --ckpt_policy {every,latest,best,none}:
                                  #   "every" saves each epoch (reference
                                  #   semantics; backpressures when a
                                  #   checkpoint write outlasts an
                                  #   epoch); "latest" skips stale
                                  #   snapshots under backpressure (the
                                  #   final epoch is always durable);
                                  #   "best" saves only epochs that
                                  #   improve the eval metric (newest
                                  #   ckpt on disk == best epoch, so
                                  #   restore(step=None) loads it);
                                  #   "none" disables checkpointing
                                  #   (ablation sweeps)
    eval_every: int = 1           # --eval_every K: run the eval pass (and
                                  #   the epoch log/ckpt-selection it
                                  #   feeds) every K-th epoch + always the
                                  #   final one. 1 = reference semantics.
                                  #   Sweeps are eval-dominated (cluster
                                  #   ablation cells: eval_s ~60x train_s
                                  #   on CPU), so K is the cheap knob.
    log_lag: int = 2              # --log_lag: defer per-step metric
                                  #   readbacks N launches so they overlap
                                  #   device execution; 0 = strictly
                                  #   synchronous per-batch prints (the
                                  #   reference's stdout timing)
    fused_epoch: bool = False     # --fused_epoch: run each FULL epoch
                                  #   (spe train steps + the whole test
                                  #   eval scan) as ONE compiled launch —
                                  #   one dispatch + one readback group
                                  #   per epoch. Implies device-resident
                                  #   pools.
    workers: int = 0              # --workers (host prefetch threads)
    device_data: bool = True      # stage the train pools in device memory
                                  #   once and gather batches on device
                                  #   (host sends [B] index vectors only);
                                  #   --host_data streams assembled
                                  #   batches from the host instead
                                  #   (the reference DataLoader model)


@dataclasses.dataclass(frozen=True)
class ClassifyConfig(BaseConfig):
    """Configs 1-2: ModelNet40 classification (BASELINE.json:7-8)."""

    num_classes: int = 40
    dropout: float = 0.3
    out_dir: str = "cls"


@dataclasses.dataclass(frozen=True)
class SegmentConfig(BaseConfig):
    """Config 3: ShapeNet-part segmentation (BASELINE.json:9)."""

    num_points: int = 2048
    num_parts: int = 50
    class_choice: Optional[str] = None  # --class_choice (single category)
    feature_transform: bool = True
    out_dir: str = "seg"


@dataclasses.dataclass(frozen=True)
class AdversarialConfig(SegmentConfig):
    """Config 4: adversarial semi-supervised segmentation (BASELINE.json:10).

    Hyperparameter defaults follow Hung et al. arXiv:1802.07934 (the method
    the reference adapts; SURVEY.md §5 "Config / flag system").
    """

    lambda_adv: float = 0.01      # --lambda_adv
    lambda_adv_unl: Optional[float] = None
                                  # --lambda_adv_unl: per-stream adversarial
                                  #   weight for the UNLABELED stream (Hung
                                  #   et al. apply eq. 3 per stream with
                                  #   separate weights, e.g. 0.01 labeled /
                                  #   0.001 semi). None = the default
                                  #   single-lambda average over both
                                  #   streams.
    lambda_semi: float = 0.1      # --lambda_semi
    semi_threshold: float = 0.2   # --threshold  (T_semi)
    labeled_ratio: float = 0.5    # --labeled_ratio (labeled/unlabeled split)
    lr_d: float = 1e-4            # discriminator Adam lr
    beta1_d: float = 0.9
    beta2_d: float = 0.99
    semi_start: int = 0           # --semi_start (iteration to enable L_semi)
    supervised_only: bool = False  # --supervised_only: ablation control —
                                  #   CE on the SAME labeled subset
                                  #   through the SAME pipeline, no
                                  #   unlabeled forward / adv / semi / D
                                  #   (the config-3 baseline the
                                  #   adversarial gain is read against)
    self_training: bool = False   # --self_training: ablation control —
                                  #   the D-FREE semi-supervised
                                  #   baseline: same labeled CE + same
                                  #   unlabeled forward, but the semi
                                  #   mask comes from the generator's
                                  #   OWN confidence (max softmax >
                                  #   --threshold) instead of the
                                  #   discriminator; no adv term, no D
                                  #   compute/update. Tests Hung et
                                  #   al.'s claim that the D's mask
                                  #   beats a plain confidence mask.
    paired_heads: bool = True     # --paired_heads: batch the T-Net fc
                                  #   head MATMULS across the labeled+
                                  #   unlabeled streams ([2B,1024] rows,
                                  #   halving the latency-bound
                                  #   tiny-matmul op count); conv
                                  #   trunks/stashes stay per-stream and
                                  #   the head's batch-axis BNs compute
                                  #   PER-STREAM statistics with the EMA
                                  #   chained a -> b
                                  #   (core.batch_norm_grouped) — exact
                                  #   sequential-call semantics, unlike
                                  #   --fused_forward's combined-2B BN.
                                  #   Default on; --no_paired_heads
                                  #   restores the sequential
                                  #   per-stream heads.
    paired_conv1: bool = False    # --paired_conv1: batch the per-point
                                  #   conv1 layers (encoder 3->64, STN
                                  #   3->64, fSTN 64->64) across the two
                                  #   streams with grouped per-stream
                                  #   BN1 statistics (exact sequential
                                  #   semantics; ops.linear_bn_act_pair).
    d_geometry: bool = False      # --d_geometry: EXTENSION beyond the
                                  #   reference — append the (augmented)
                                  #   xyz coordinates to the D's input
                                  #   ([B,N,k+3]). The reference's
                                  #   pointwise D sees only per-point
                                  #   class probabilities, so its prior
                                  #   reduces to marginal shape
                                  #   (docs/ADVERSARIAL_GAIN.md); with
                                  #   coordinates it can
                                  #   judge label-geometry consistency.
                                  #   Changes the D architecture (input
                                  #   width), so checkpoints are not
                                  #   interchangeable with the default.
    fused_forward: bool = False   # one combined G fwd / D pass over
                                  #   [labeled; unlabeled]; changes BN
                                  #   stats to the combined batch.
                                  #   Default off.
    out_dir: str = "adv"


@dataclasses.dataclass(frozen=True)
class AdvPerturbConfig(BaseConfig):
    """Config 5: FGSM perturbation training + multi-chip DP (BASELINE.json:11)."""

    num_classes: int = 40
    dropout: float = 0.3
    epsilon: float = 0.05         # --epsilon (FGSM step / L-inf bound)
    attack: str = "fgsm"          # --attack {fgsm,pgd}: pgd runs
                                  #   attack_steps projected iterations
                                  #   inside the same jitted step
                                  #   (steps=1 pgd == fgsm exactly)
    attack_steps: int = 1         # --attack_steps (PGD iterations)
    out_dir: str = "advp"


def _add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batchSize", type=int, default=32, help="input batch size")
    p.add_argument("--num_points", type=int, default=None, help="points per cloud")
    p.add_argument("--nepoch", type=int, default=250, help="number of epochs")
    p.add_argument("--outf", type=str, default=None, help="output folder")
    p.add_argument("--model", type=str, default=None,
                   help="checkpoint to warm-start from: a checkpoint dir "
                        "written by these trainers, or a reference "
                        "torch .pth state_dict (params+BN; optimizer "
                        "restarts — the reference's --model semantics)")
    p.add_argument("--dataset", type=str, default="", help="dataset root path")
    p.add_argument("--manualSeed", type=int, default=0, help="random seed")
    p.add_argument("--feature_transform", action="store_true",
                   help="use feature transform (STNkd + ortho regularizer)")
    p.add_argument("--augment", action="store_true",
                   help="on-device rotate/jitter augmentation")
    p.add_argument("--no_normalize", action="store_true",
                   help="skip unit-sphere normalization (reference "
                        "normalizes every shape in __getitem__)")
    p.add_argument("--no_resample", action="store_true",
                   help="freeze one host-side fixed-N subsample per run "
                        "instead of a fresh on-device draw per batch")
    p.add_argument("--point_dropout", action="store_true",
                   help="random point dropout (provider.py convention, "
                        "max dropout ratio 0.875)")
    p.add_argument("--scan", type=int, default=0,
                   help="fuse K train steps per program launch via "
                        "lax.scan (K-batch stacked host transfers)")
    p.add_argument("--optimizer", type=str, default="adam",
                   choices=("adam", "sgd"),
                   help="sgd(momentum 0.9) is Hung et al.'s G optimizer")
    p.add_argument("--lr_schedule", type=str, default="step",
                   choices=("step", "poly"),
                   help="poly = Hung et al.'s (1-step/total)^0.9 decay")
    p.add_argument("--poly_power", type=float, default=0.9)
    p.add_argument("--no_pallas", action="store_true",
                   help="never take the trunk-exit kernel (plain jnp/XLA "
                        "path everywhere)")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision (bf16 matmul inputs, fp32 accum)")
    p.add_argument("--remat", action="store_true",
                   help="recompute big activations in backward — shrinks "
                        "the device-memory footprint for much larger "
                        "batch/point counts; memory knob only")
    p.add_argument("--resume_full", action="store_true",
                   help="restore FULL train state from --model (optimizer, "
                        "RNG, step) instead of reference-style params-only")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a jax.profiler trace here")
    p.add_argument("--quiet", action="store_true", help="reference-style stdout only")
    p.add_argument("--ckpt_policy", type=str, default="every",
                   choices=("every", "latest", "best", "none"),
                   help="'every' saves each epoch (reference semantics); "
                        "'latest' skips stale snapshots when epochs "
                        "outpace the async checkpoint writer (final "
                        "epoch always durable); 'best' saves only "
                        "epochs that improve the eval metric (the "
                        "newest checkpoint on disk is the best epoch); "
                        "'none' disables checkpointing (ablation sweeps)")
    p.add_argument("--eval_every", type=int, default=1,
                   help="run the eval pass every K-th epoch (+ always "
                        "the final one); epoch rows/checkpoint metric "
                        "selection follow the eval (1 = reference "
                        "semantics: eval every epoch)")
    p.add_argument("--log_lag", type=int, default=2,
                   help="defer per-step metric readbacks this many "
                        "launches (overlaps device execution); 0 = "
                        "strictly synchronous per-batch prints (the "
                        "reference behavior)")
    p.add_argument("--workers", type=int, default=0, help="host loader threads")
    p.add_argument("--host_data", action="store_true",
                   help="stream assembled batches from the host (the "
                        "reference DataLoader model) instead of the "
                        "default device-resident pools + on-device "
                        "batch gather ([B] index transfers only)")
    p.add_argument("--fused_epoch", action="store_true",
                   help="one compiled launch per epoch (train scan + "
                        "eval scan); requires device-resident pools")
    p.add_argument("--num_devices", type=int, default=0,
                   help="DP mesh size (0 = all visible devices)")


def _common_kwargs(a: argparse.Namespace, default_points: int, default_outf: str):
    return dict(
        batch_size=a.batchSize,
        num_points=a.num_points if a.num_points is not None else default_points,
        epochs=a.nepoch,
        out_dir=a.outf if a.outf is not None else default_outf,
        resume=a.model,
        dataset=a.dataset,
        seed=a.manualSeed,
        feature_transform=a.feature_transform,
        augment=a.augment,
        normalize=not a.no_normalize,
        resample=not a.no_resample,
        point_dropout=a.point_dropout,
        scan=a.scan,
        optimizer=a.optimizer,
        lr_schedule=a.lr_schedule,
        poly_power=a.poly_power,
        use_pallas=not a.no_pallas,
        bf16=a.bf16,
        remat=a.remat,
        resume_full=a.resume_full,
        profile_dir=a.profile_dir,
        quiet=a.quiet,
        ckpt_policy=a.ckpt_policy,
        eval_every=a.eval_every,
        log_lag=a.log_lag,
        workers=a.workers,
        device_data=not a.host_data,
        fused_epoch=a.fused_epoch,
        num_devices=a.num_devices,
    )


def classify_config_from_args(argv=None) -> ClassifyConfig:
    """CLI shim for ``train_classification.py`` (reference flag names)."""
    p = argparse.ArgumentParser(description="PointNet classification")
    _add_common_flags(p)
    a = p.parse_args(argv)
    return ClassifyConfig(**_common_kwargs(a, 1024, "cls"))


def segment_config_from_args(argv=None) -> SegmentConfig:
    """CLI shim for ``train_segmentation.py``."""
    p = argparse.ArgumentParser(description="PointNet part segmentation")
    _add_common_flags(p)
    p.add_argument("--class_choice", type=str, default=None,
                   help="restrict to one ShapeNet category")
    a = p.parse_args(argv)
    kw = _common_kwargs(a, 2048, "seg")
    kw.pop("feature_transform")
    return SegmentConfig(class_choice=a.class_choice,
                         feature_transform=a.feature_transform, **kw)


def adversarial_config_from_args(argv=None) -> AdversarialConfig:
    """CLI shim for ``train_adversarial.py``."""
    p = argparse.ArgumentParser(
        description="Adversarial semi-supervised segmentation")
    _add_common_flags(p)
    p.add_argument("--class_choice", type=str, default=None)
    p.add_argument("--lambda_adv", type=float, default=0.01)
    p.add_argument("--lambda_adv_unl", type=float, default=None,
                   help="separate adversarial weight for the unlabeled "
                        "stream (Hung et al. per-stream eq. 3, e.g. "
                        "0.001); default: single lambda_adv averaged "
                        "over both streams")
    p.add_argument("--lambda_semi", type=float, default=0.1)
    p.add_argument("--threshold", type=float, default=0.2,
                   help="T_semi confidence threshold")
    p.add_argument("--labeled_ratio", type=float, default=0.5)
    p.add_argument("--lr_D", type=float, default=1e-4)
    p.add_argument("--semi_start", type=int, default=0)
    p.add_argument("--supervised_only", action="store_true",
                   help="ablation control: CE-only training on the same "
                        "labeled subset (no adv/semi/D) — the baseline "
                        "the adversarial gain is measured against")
    p.add_argument("--self_training", action="store_true",
                   help="ablation control: D-free semi-supervised "
                        "baseline — pseudo-label mask from the "
                        "generator's own confidence (max softmax > "
                        "--threshold) instead of the discriminator; "
                        "no adv term, no D")
    p.add_argument("--paired_heads", dest="paired_heads",
                   action="store_true", default=True,
                   help="batch the T-Net fc head matmuls across the "
                        "labeled and unlabeled streams; BN statistics "
                        "stay per-stream (grouped BN — exact sequential "
                        "semantics). DEFAULT ON")
    p.add_argument("--no_paired_heads", dest="paired_heads",
                   action="store_false",
                   help="disable the cross-stream-batched T-Net fc heads "
                        "(run the two streams' heads sequentially)")
    p.add_argument("--paired_conv1", action="store_true",
                   help="batch the per-point conv1 layers across the two "
                        "streams (grouped per-stream BN1 statistics — "
                        "exact sequential semantics); requires paired "
                        "heads")
    p.add_argument("--fused_forward", action="store_true",
                   help="one combined G forward over [labeled; unlabeled] "
                        "(BN stats over the combined batch)")
    p.add_argument("--d_geometry", action="store_true",
                   help="EXTENSION: append xyz coordinates to the "
                        "discriminator input so it can judge "
                        "label-geometry consistency (the reference's "
                        "pointwise D sees probabilities only)")
    a = p.parse_args(argv)
    if a.paired_conv1 and (not a.paired_heads or a.fused_forward):
        p.error("--paired_conv1 requires the paired-heads path "
                "(drop --no_paired_heads / --fused_forward)")
    kw = _common_kwargs(a, 2048, "adv")
    kw.pop("feature_transform")
    return AdversarialConfig(
        class_choice=a.class_choice,
        feature_transform=a.feature_transform,
        lambda_adv=a.lambda_adv,
        lambda_adv_unl=a.lambda_adv_unl,
        lambda_semi=a.lambda_semi,
        semi_threshold=a.threshold,
        supervised_only=a.supervised_only,
        self_training=a.self_training,
        # Shared dest, default True: --no_paired_heads flips it off and
        # passing both resolves to whichever came last (argparse
        # last-wins), so neither flag is dead (ADVICE r3).
        paired_heads=a.paired_heads,
        paired_conv1=a.paired_conv1,
        fused_forward=a.fused_forward,
        d_geometry=a.d_geometry,
        labeled_ratio=a.labeled_ratio,
        lr_d=a.lr_D,
        semi_start=a.semi_start,
        **kw,
    )


def adv_perturb_config_from_args(argv=None) -> AdvPerturbConfig:
    """CLI shim for ``train_adv_perturb.py`` (FGSM config)."""
    p = argparse.ArgumentParser(description="FGSM perturbation training")
    _add_common_flags(p)
    p.add_argument("--epsilon", type=float, default=0.05, help="FGSM epsilon")
    p.add_argument("--attack", type=str, default="fgsm",
                   choices=("fgsm", "pgd"),
                   help="pgd = iterated projected FGSM (--attack_steps)")
    p.add_argument("--attack_steps", type=int, default=1,
                   help="PGD iterations (1 == FGSM)")
    a = p.parse_args(argv)
    return AdvPerturbConfig(epsilon=a.epsilon, attack=a.attack,
                            attack_steps=a.attack_steps,
                            **_common_kwargs(a, 1024, "advp"))
