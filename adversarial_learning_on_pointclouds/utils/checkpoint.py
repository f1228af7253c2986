"""Checkpoint / resume (SURVEY.md §5 "Checkpoint / resume").

The reference ``torch.save``s the model state_dict each epoch and
warm-starts params-only via ``--model path.pth`` (optimizer state is NOT
saved in the lineage). Here the default is strictly stronger: the FULL
train state (params, BN stats, both optimizer states, RNG key, step)
round-trips through step-numbered directories, with
``load_params_only`` mirroring the reference's weaker resume semantics.

Format: ``<ckpt_dir>/<step>/state.npz`` holds the flattened pytree's
leaves (``leaf_<i>``) and their key paths (``__paths__``). A restore
takes its structure from a template and checks the paths against it, so
a checkpoint of another architecture fails with a readable error.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
from typing import Any, Dict, Optional, Sequence

import jax
import numpy as np

_FILE = "state.npz"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _flatten(tree: Any) -> Dict[str, Any]:
    """``{key path: leaf}`` in flattening order."""
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def save(ckpt_dir: str, step: int, state: Any) -> str:
    """Save a pytree train state under ``ckpt_dir/<step>``."""
    path = os.path.join(_abs(ckpt_dir), str(step))
    os.makedirs(path, exist_ok=True)
    leaves = _flatten(jax.device_get(state))
    arrays = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves.values())}
    tmp = os.path.join(path, _FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, __paths__=np.array(list(leaves), dtype=str), **arrays)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def _load(path: str) -> Dict[str, np.ndarray]:
    """``{key path: array}`` of a saved checkpoint directory."""
    with np.load(os.path.join(path, _FILE)) as z:
        paths = [str(p) for p in z["__paths__"]]
        return {p: z[f"leaf_{i}"] for i, p in enumerate(paths)}


def _fill(like: Any, saved: Dict[str, np.ndarray], prefix: str,
          where: str) -> Any:
    """Rebuild ``like``'s structure from ``saved`` leaves stored under
    ``prefix + <like's key path>``; every path must match exactly."""
    want = [prefix + p for p in _flatten(like)]
    have = [p for p in saved if not prefix or p.startswith(prefix + "[")
            or p.startswith(prefix + ".")]
    if sorted(want) != sorted(have):
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        raise ValueError(
            f"checkpoint {where!r} does not match the state template"
            + (f"; missing {missing[:4]}" if missing else "")
            + (f"; unexpected {extra[:4]}" if extra else ""))
    leaves, treedef = jax.tree_util.tree_flatten(like)
    vals = []
    for p, leaf in zip(want, leaves):
        val = saved[p]
        if np.shape(val) != np.shape(leaf):
            raise ValueError(f"checkpoint {where!r}: {p} has shape "
                             f"{np.shape(val)}, template {np.shape(leaf)}")
        vals.append(jax.numpy.asarray(val, dtype=leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, vals)


class AsyncSaver:
    """Background checkpoint writer: the device->host state transfer
    (~60 MB of params + two optimizer states) and the file write run off
    the training thread, overlapping the next epoch. JAX arrays are immutable, so
    capturing the state is snapshot-safe. ``maxsize=1`` gives natural
    backpressure (a third save blocks until the first lands); ``close()``
    drains the queue so the final checkpoint is durable before the run
    returns, and re-raises any writer-thread failure.

    ``policy`` is the whole ``--ckpt_policy`` knob in one place (the
    runners pass the config string straight through, no per-call-site
    guards):

    - ``"every"`` (default, reference semantics): every epoch saved,
      ``maxsize=1`` backpressure.
    - ``"latest"`` (keep-up mode): trades completeness for zero
      backpressure when epochs finish faster than a checkpoint write
      — a save that finds the queue full REPLACES
      the still-queued stale snapshot with the newer one instead of
      blocking; the writer persists the most recent state it can keep
      up with, intermediate epochs may be skipped. The FINAL state is
      always durable either way (``close()`` enqueues behind any
      pending item and drains before returning).
    - ``"best"`` (model-selection mode): save only when the caller's
      ``metric`` improves on the best seen so far (callers pass the
      epoch's eval accuracy/mIoU). The newest checkpoint on disk is
      therefore the best-metric epoch — which is exactly what
      ``restore(step=None)`` loads. Unlike every/latest the FINAL epoch
      is not necessarily durable; that is the point of the policy.
      A ``save()`` without a metric is unconditional (explicit final
      saves remain possible).
    - ``"none"`` (sweep mode): ``save()`` is a no-op."""

    def __init__(self, policy: str = "every") -> None:
        assert policy in ("every", "latest", "none", "best"), policy
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._skip = policy == "latest"
        self._off = policy == "none"
        self._best = policy == "best"
        self._best_metric: Optional[float] = None
        self._err: Optional[BaseException] = None
        # Sticky record: set the first time ANY write fails and never
        # cleared, so close() re-surfaces the failure even if a caller
        # caught the save()-time raise and carried on — a run with a
        # missing checkpoint epoch must not finish reporting success.
        self.had_error: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                ckpt_dir, step, state = item
                save(ckpt_dir, step, state)
            except BaseException as e:  # re-raised on next save()/close()
                # Log immediately from the writer thread so a broken
                # out_dir is visible AT the failing epoch (the re-raise
                # necessarily lands one save() call later).
                print(f"[AsyncSaver] checkpoint write for step "
                      f"{item[1]} failed: {e!r}", file=sys.stderr,
                      flush=True)
                self._err = e
                if self.had_error is None:
                    self.had_error = e
            finally:
                self._q.task_done()

    def save(self, ckpt_dir: str, step: int, state: Any,
             metric: Optional[float] = None) -> None:
        """Enqueue a checkpoint write. ``metric`` (higher = better) only
        matters under the ``best`` policy; other policies ignore it."""
        if self._off:
            return
        if self._best and metric is not None:
            if (self._best_metric is not None
                    and metric <= self._best_metric):
                return
            self._best_metric = float(metric)
        if self._err is not None:
            err, self._err = self._err, None  # raise once, not forever
            raise err
        item = (ckpt_dir, step, state)
        if not self._skip:
            self._q.put(item)
            return
        # Keep-up mode: displace a stale queued snapshot rather than
        # block. The pop/put pair races benignly with the writer thread —
        # if the writer grabs the stale item first, get_nowait sees Empty
        # and the retry put succeeds (or displaces whatever newer save
        # landed in between, which is exactly the policy).
        while True:
            try:
                self._q.put_nowait(item)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self._q.task_done()
                except queue.Empty:
                    pass

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        if self.had_error is not None:
            # Already raised once at a save() call, but the run is about
            # to finish — surface the gap rather than end silently green.
            raise RuntimeError(
                "AsyncSaver: an earlier checkpoint write failed (a saved "
                "epoch is missing on disk)") from self.had_error

    def __enter__(self) -> "AsyncSaver":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.close()
        else:  # don't mask the in-flight exception; best-effort drain
            try:
                self.close()
            except BaseException:
                pass
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = _abs(ckpt_dir)
    if not os.path.isdir(d):
        return None
    steps = [int(n) for n in os.listdir(d)
             if n.isdigit() and os.path.exists(os.path.join(d, n, _FILE))]
    return max(steps) if steps else None


def _resolve_path(ckpt_dir: str, step: Optional[int]) -> str:
    """``step=None`` -> the latest checkpoint's directory (one place for
    the latest-step policy; shared by ``restore`` and
    ``restore_fields``)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    return os.path.join(_abs(ckpt_dir), str(step))


def restore(ckpt_dir: str, state_like: Any, step: Optional[int] = None) -> Any:
    """Restore the full train state (structure taken from ``state_like``).

    ``step=None`` restores the latest checkpoint (``--resume latest``).
    """
    if ckpt_dir.endswith(".pth"):
        raise ValueError(
            f"{ckpt_dir!r}: full-state resume cannot load a reference "
            ".pth — the format holds params/BN only (no optimizer state, "
            "step, or RNG). Drop --resume_full to warm-start params-only, "
            "the reference's --model semantics.")
    path = _resolve_path(ckpt_dir, step)
    return _fill(state_like, _load(path), "", path)


def restore_fields(ckpt_dir: str, state_like: Any, fields: Sequence[str],
                   step: Optional[int] = None) -> Dict[str, Any]:
    """Restore only the named top-level fields of a NamedTuple train
    state, returned as ``{field: subtree}``.

    Inference from an adversarial checkpoint needs just the generator
    subtree (``g_params`` + ``g_bn_state``); restoring through a
    full-state template would force the DISCRIMINATOR template to match
    too, which fails for checkpoints trained with options that change
    D's shapes (e.g. ``--d_geometry``'s wider D input) even though D is
    irrelevant to inference (``scripts/infer.py``). Saved key paths
    start with the field's ``.name``, so each field is rebuilt on its
    own against the matching ``state_like`` subtree."""
    path = _resolve_path(ckpt_dir, step)
    saved = _load(path)
    return {name: _fill(getattr(state_like, name), saved, f".{name}", path)
            for name in fields}


def _pth_tree_check(what: str, new: Any, like: Any) -> None:
    """Raise a readable error when an imported ``.pth`` doesn't match the
    run's template tree (typical causes: ``--feature_transform`` /
    ``--num_classes`` / ``--num_parts`` / ``--d_geometry`` mismatch, or a
    checkpoint of the wrong architecture)."""
    jtu = jax.tree_util
    a = {jtu.keystr(p): np.shape(v)
         for p, v in jtu.tree_flatten_with_path(new)[0]}
    b = {jtu.keystr(p): np.shape(v)
         for p, v in jtu.tree_flatten_with_path(like)[0]}
    if a == b:
        return
    missing = sorted(set(b) - set(a))
    extra = sorted(set(a) - set(b))
    wrong = [f"{k}: {a[k]} != {b[k]}"
             for k in sorted(set(a) & set(b)) if a[k] != b[k]]
    raise ValueError(
        f".pth does not match this run's {what} template"
        + (f"; missing {missing[:4]}" if missing else "")
        + (f"; unexpected {extra[:4]}" if extra else "")
        + (f"; shape mismatch {wrong[:4]}" if wrong else "")
        + " — check --feature_transform / --num_classes / --num_parts"
          " / --d_geometry against how the .pth was trained.")


def load_pth_warm_start(path: str, state_like: Any) -> Any:
    """Reference ``torch.save(state_dict)`` checkpoint -> params/BN warm
    start, exactly the reference CLI's ``--model model_24.pth`` semantics
    (optimizer state / step / RNG stay fresh; SURVEY.md §2.10).

    Architecture is detected from the state_dict's top-level keys
    (classifier: ``fc3``; segmenter: ``conv4`` — T-Net fc3/conv4 live
    under ``feat.*`` prefixes, so the top level is unambiguous). A GAN
    train state takes the segmenter G from ``path``; if the
    ``<path minus .pth>_D.pth`` companion written by
    ``scripts/export_pth.py --arch adv`` sits next to it, the
    discriminator loads too, else D keeps its fresh init (the reference
    lineage checkpoints G and D as separate files)."""
    from . import torch_import as ti

    cast = lambda like, val: jax.numpy.asarray(val, dtype=like.dtype)  # noqa: E731
    sd = ti.load_pth(path)
    if hasattr(state_like, "g_params"):
        params, bn = ti.segmenter_from_state_dict(sd)
        _pth_tree_check("generator", params, state_like.g_params)
        _pth_tree_check("generator BN", bn, state_like.g_bn_state)
        out = state_like._replace(
            g_params=jax.tree_util.tree_map(cast, state_like.g_params,
                                            params),
            g_bn_state=jax.tree_util.tree_map(cast, state_like.g_bn_state,
                                              bn))
        d_path = path[:-len(".pth")] + "_D.pth"
        if os.path.exists(d_path):
            d_params = ti.discriminator_from_state_dict(ti.load_pth(d_path))
            _pth_tree_check("discriminator", d_params, state_like.d_params)
            out = out._replace(
                d_params=jax.tree_util.tree_map(cast, state_like.d_params,
                                                d_params))
        return out
    if "conv4.weight" in sd:
        params, bn = ti.segmenter_from_state_dict(sd)
    elif "fc3.weight" in sd:
        params, bn = ti.classifier_from_state_dict(sd)
    else:
        raise ValueError(
            f"{path!r}: not a recognized reference state_dict (no "
            "top-level conv4/fc3 — expected PointNetCls or "
            "PointNetDenseCls keys)")
    _pth_tree_check("model", params, state_like.params)
    _pth_tree_check("model BN", bn, state_like.bn_state)
    return state_like._replace(
        params=jax.tree_util.tree_map(cast, state_like.params, params),
        bn_state=jax.tree_util.tree_map(cast, state_like.bn_state, bn))


def load_pth_generator(path: str, gan_state_like: Any):
    """Reference segmenter ``.pth`` -> ``(g_params, g_bn_state)`` checked
    against a GAN train-state template's generator subtree.

    The generator-only twin of ``restore_fields``'s adv-inference path:
    D is never touched, so a template whose D differs from the
    checkpoint's training options (``--d_geometry``) cannot block the
    load — but the GENERATOR trees are still validated, so a ``.pth``
    trained with a different ``--num_parts``/``--feature_transform``
    fails with the readable template error instead of a shape error at
    apply time."""
    from . import torch_import as ti

    params, bn = ti.segmenter_from_state_dict(ti.load_pth(path))
    _pth_tree_check("generator", params, gan_state_like.g_params)
    _pth_tree_check("generator BN", bn, gan_state_like.g_bn_state)
    cast = lambda like, val: jax.numpy.asarray(val, dtype=like.dtype)  # noqa: E731
    return (jax.tree_util.tree_map(cast, gan_state_like.g_params, params),
            jax.tree_util.tree_map(cast, gan_state_like.g_bn_state, bn))


def load_params_only(ckpt_dir: str, state_like: Any,
                     step: Optional[int] = None) -> Any:
    """Reference-compat resume: take params + BN stats from the
    checkpoint, keep fresh optimizer state / step / RNG (the lineage's
    ``--model`` warm-start restarts the optimizer).

    A ``*.pth`` path loads the reference torch format directly
    (``load_pth_warm_start``), so ``--model model_24.pth`` works
    unchanged for users migrating mid-training-run from the reference."""
    if ckpt_dir.endswith(".pth"):
        return load_pth_warm_start(ckpt_dir, state_like)
    restored = restore(ckpt_dir, state_like, step)
    fields = {}
    for name in state_like._fields:
        if "params" in name or "bn_state" in name:
            fields[name] = getattr(restored, name)
        else:
            fields[name] = getattr(state_like, name)
    return type(state_like)(**fields)
