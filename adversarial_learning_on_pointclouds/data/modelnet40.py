"""ModelNet40 HDF5 dataset (classification).

Schema parity with the reference loader (``upstream:dataset.py``,
SURVEY.md §2.1): shard files ``ply_data_{train,test}*.h5`` with keys
``data`` ``[S, 2048, 3] float32`` and ``label`` ``[S, 1] uint8``, shard
lists in ``{train,test}_files.txt``. All shards are concatenated into host
RAM; per-batch fixed-N resampling and augmentation happen on device.

No datasets ship with the repo: ``synthetic_modelnet_arrays`` generates
fixture clouds in memory (the trainers' default when ``cfg.dataset ==
''``), and ``make_synthetic_modelnet_h5`` writes the same arrays with the
exact real schema. ``h5py`` is imported only where an HDF5 file is read
or written.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

NUM_CLASSES = 40


class ModelNet40:
    """Host-side reader. ``points`` [S, N0, 3] float32; ``labels`` [S] int32."""

    def __init__(self, root: str, split: str = "train"):
        list_file = os.path.join(root, f"{split}_files.txt")
        if os.path.exists(list_file):
            with open(list_file) as f:
                shards = [ln.strip() for ln in f if ln.strip()]
            # Reference lists paths relative to the data root's parent.
            shards = [s if os.path.isabs(s) else
                      os.path.join(root, os.path.basename(s)) for s in shards]
        else:
            shards = sorted(
                os.path.join(root, fn) for fn in os.listdir(root)
                if fn.endswith(".h5") and split in fn)
        if not shards:
            raise FileNotFoundError(
                f"no ModelNet40 {split} shards under {root!r}")
        import h5py

        datas, labels = [], []
        for path in shards:
            with h5py.File(path, "r") as f:
                datas.append(np.asarray(f["data"], dtype=np.float32))
                labels.append(np.asarray(f["label"], dtype=np.int64).reshape(-1))
        self.points = np.concatenate(datas, axis=0)
        self.labels = np.concatenate(labels, axis=0).astype(np.int32)

    @classmethod
    def from_arrays(cls, points: np.ndarray, labels: np.ndarray
                    ) -> "ModelNet40":
        ds = cls.__new__(cls)
        ds.points = np.asarray(points, np.float32)
        ds.labels = np.asarray(labels).reshape(-1).astype(np.int32)
        return ds

    def __len__(self) -> int:
        return self.points.shape[0]

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.points[i], self.labels[i]


def _synthetic_shards(num_train: int, num_test: int, num_points: int,
                      num_classes: int, seed: int, shards: int = 2):
    """Yield ``(split, shard_index, points, labels [n, 1] uint8)``.

    Shapes are class-conditioned gaussian blobs plus a class-dependent
    anisotropic scaling, so a classifier can actually overfit them (used
    by the integration tests)."""
    rng = np.random.default_rng(seed)
    for split, count in (("train", num_train), ("test", num_test)):
        per = -(-count // shards)
        for si in range(shards):
            n = min(per, count - si * per)
            if n <= 0:
                break
            labels = rng.integers(0, num_classes, size=(n, 1), dtype=np.uint8)
            pts = rng.standard_normal((n, num_points, 3)).astype(np.float32)
            scale = 0.5 + 1.5 * (labels.astype(np.float32) / num_classes)
            pts[..., 0] *= scale[:, None, 0, None].squeeze(-1)
            pts[..., 1] *= (2.0 - scale)[:, None, 0, None].squeeze(-1)
            norm = np.max(np.linalg.norm(pts, axis=-1, keepdims=True),
                          axis=1, keepdims=True)
            yield split, si, pts / np.maximum(norm, 1e-12), labels


def synthetic_modelnet_arrays(num_train: int = 64, num_test: int = 32,
                              num_points: int = 2048,
                              num_classes: int = NUM_CLASSES, seed: int = 0,
                              ) -> Tuple[ModelNet40, ModelNet40]:
    """The synthetic fixture as in-memory ``(train, test)`` datasets —
    the same arrays ``make_synthetic_modelnet_h5`` writes."""
    parts = {"train": ([], []), "test": ([], [])}
    for split, _, pts, labels in _synthetic_shards(
            num_train, num_test, num_points, num_classes, seed):
        parts[split][0].append(pts)
        parts[split][1].append(labels)
    return tuple(ModelNet40.from_arrays(np.concatenate(p), np.concatenate(l))
                 for p, l in (parts["train"], parts["test"]))


def make_synthetic_modelnet_h5(root: str, num_train: int = 64,
                               num_test: int = 32, num_points: int = 2048,
                               num_classes: int = NUM_CLASSES,
                               seed: int = 0) -> str:
    """Write the synthetic fixture shards with the real ModelNet40 h5
    schema."""
    import h5py

    os.makedirs(root, exist_ok=True)
    names = {"train": [], "test": []}
    for split, si, pts, labels in _synthetic_shards(
            num_train, num_test, num_points, num_classes, seed):
        name = f"ply_data_{split}{si}.h5"
        with h5py.File(os.path.join(root, name), "w") as f:
            f.create_dataset("data", data=pts)
            f.create_dataset("label", data=labels)
        names[split].append(name)
    for split, shard_names in names.items():
        with open(os.path.join(root, f"{split}_files.txt"), "w") as f:
            f.write("\n".join(shard_names) + "\n")
    return root
