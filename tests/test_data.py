"""Data layer tests against synthetic fixtures with the real schemas."""

import os

import numpy as np
import pytest

from adversarial_learning_on_pointclouds.data import (
    ModelNet40, ShapeNetPart, batch_iterator, make_synthetic_shapenet,
)
from adversarial_learning_on_pointclouds.data.loader import num_batches
from adversarial_learning_on_pointclouds.data.shapenet_part import (
    CATEGORY_PART_RANGES, SEG_CLASSES,
)


def test_modelnet_loader(modelnet_root):
    train = ModelNet40(modelnet_root, "train")
    test = ModelNet40(modelnet_root, "test")
    assert len(train) == 48 and len(test) == 16
    assert train.points.shape == (48, 256, 3)
    assert train.points.dtype == np.float32
    assert train.labels.dtype == np.int32
    assert train.labels.min() >= 0 and train.labels.max() < 40
    pts, label = train[0]
    assert pts.shape == (256, 3)


def test_modelnet_shard_concatenation(modelnet_root):
    # Fixture writes 2 shards listed in train_files.txt; both must load.
    with open(os.path.join(modelnet_root, "train_files.txt")) as f:
        shards = [ln.strip() for ln in f if ln.strip()]
    assert len(shards) == 2


def test_shapenet_loader(shapenet_root):
    train = ShapeNetPart(shapenet_root, "train")
    assert len(train) == 36
    pts, seg, cat = train.as_arrays(num_points=128)
    assert pts.shape == (36, 128, 3)
    assert seg.shape == (36, 128)
    # Part labels must lie inside each shape's category range.
    for i in range(len(train)):
        start, count = CATEGORY_PART_RANGES[cat[i]]
        assert seg[i].min() >= start
        assert seg[i].max() < start + count


def test_seg_classes_table_is_partition():
    """The 16 categories' part ids partition [0, 50) contiguously."""
    all_parts = sorted(p for parts in SEG_CLASSES.values() for p in parts)
    assert all_parts == list(range(50))
    for parts in SEG_CLASSES.values():
        assert parts == list(range(parts[0], parts[0] + len(parts)))


def test_shapenet_class_choice(shapenet_root):
    full = ShapeNetPart(shapenet_root, "train")
    cats = set(int(c) for c in full.category)
    from adversarial_learning_on_pointclouds.data.shapenet_part import (
        CATEGORY_NAMES,
    )
    pick = CATEGORY_NAMES[next(iter(cats))]
    sub = ShapeNetPart(shapenet_root, "train", class_choice=pick)
    assert len(sub) >= 1
    assert all(CATEGORY_NAMES[c] == pick for c in sub.category)


def test_batch_iterator_shapes_and_drop_last():
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.int32)
    batches = list(batch_iterator((x, y), batch_size=4, shuffle=False,
                                  drop_last=True, prefetch=0))
    assert len(batches) == 2 == num_batches(10, 4, True)
    assert batches[0][0].shape == (4, 3)

    padded = list(batch_iterator((x, y), batch_size=4, shuffle=False,
                                 drop_last=False, prefetch=0))
    assert len(padded) == 3 == num_batches(10, 4, False)
    last = padded[-1]
    assert len(last) == 3  # mask appended
    assert last[0].shape == (4, 3)
    np.testing.assert_array_equal(np.asarray(last[2]),
                                  [True, True, False, False])


def test_batch_iterator_shuffle_determinism_and_prefetch():
    x = np.arange(32, dtype=np.float32).reshape(32, 1)
    a = [np.asarray(b[0]) for b in batch_iterator(
        (x,), 8, shuffle=True, seed=1, epoch=3, prefetch=0)]
    b = [np.asarray(b[0]) for b in batch_iterator(
        (x,), 8, shuffle=True, seed=1, epoch=3, prefetch=2)]
    np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b))
    c = [np.asarray(b[0]) for b in batch_iterator(
        (x,), 8, shuffle=True, seed=1, epoch=4, prefetch=0)]
    assert not np.array_equal(np.concatenate(a), np.concatenate(c))
    # Every element appears exactly once.
    np.testing.assert_array_equal(np.sort(np.concatenate(a), axis=0), x)


def test_shapenet_pts_layout_native_loader(tmp_path):
    """The per-shape .pts/.seg layout through the native C++ loader:
    schema, category-range correctness, determinism, h5-parity of label
    semantics."""
    from adversarial_learning_on_pointclouds.data.shapenet_part import (
        make_synthetic_shapenet,
    )
    root = make_synthetic_shapenet(str(tmp_path / "pts"), num_shapes=24,
                                   num_points=200, layout="pts")
    ds = ShapeNetPart(root, "train")
    assert len(ds) == 18
    pts, seg, cat = ds.as_arrays(num_points=96, seed=3)
    assert pts.shape == (18, 96, 3) and seg.shape == (18, 96)
    for i in range(len(ds)):
        start, count = CATEGORY_PART_RANGES[cat[i]]
        assert seg[i].min() >= start and seg[i].max() < start + count
    # determinism
    pts2, seg2, _ = ds.as_arrays(num_points=96, seed=3)
    np.testing.assert_array_equal(pts, pts2)
    np.testing.assert_array_equal(seg, seg2)
    # lazy __getitem__ API
    p0, s0, c0 = ds[0]
    assert p0.ndim == 2 and p0.shape[1] == 3
    assert len(s0) == len(p0)
    start, count = CATEGORY_PART_RANGES[c0]
    assert s0.min() >= start and s0.max() < start + count


def test_shapenet_pts_class_choice(tmp_path):
    from adversarial_learning_on_pointclouds.data.shapenet_part import (
        CATEGORY_NAMES, make_synthetic_shapenet,
    )
    root = make_synthetic_shapenet(str(tmp_path / "pts2"), num_shapes=32,
                                   num_points=128, layout="pts")
    full = ShapeNetPart(root, "train")
    pick = CATEGORY_NAMES[int(full.category[0])]
    sub = ShapeNetPart(root, "train", class_choice=pick)
    assert 1 <= len(sub) <= len(full)
    pts, seg, cat = sub.as_arrays(64)
    assert pts.shape[0] == len(sub)
    assert all(CATEGORY_NAMES[c] == pick for c in cat)


def test_host_index_iterator_matches_batch_stream():
    """host_index_iterator yields the SAME permutation stream as
    host_batch_iterator (the device-data path's contract: gathering
    pool[idx] on device must see the rows the host path would send)."""
    from adversarial_learning_on_pointclouds.data.loader import (
        cycling_host_batches, cycling_host_indices, host_batch_iterator,
        host_index_iterator,
    )

    x = np.arange(26, dtype=np.float32).reshape(26, 1)
    for epoch in (0, 3):
        rows = [b[0] for b in host_batch_iterator(
            (x,), 8, seed=5, epoch=epoch)]
        idxs = list(host_index_iterator(26, 8, seed=5, epoch=epoch))
        assert len(rows) == len(idxs) == 3  # drop_last
        for r, i in zip(rows, idxs):
            assert i.dtype == np.int32
            np.testing.assert_array_equal(r, x[i])

    stream = cycling_host_batches((x,), 8, seed=9)
    istream = cycling_host_indices(26, 8, seed=9)
    for _ in range(8):  # crosses the epoch boundary (3 batches/pass)
        (r,), i = next(stream), next(istream)
        np.testing.assert_array_equal(r, x[i])


def test_host_index_iterator_masked_padding():
    """drop_last=False yields (idx, mask) pairs — pad rows are index 0
    but masked out, so a consumer can't confuse them with genuine row 0;
    the batch iterator's padded+mask protocol composes from this."""
    from adversarial_learning_on_pointclouds.data.loader import (
        host_batch_iterator, host_index_iterator,
    )

    x = np.arange(10, dtype=np.float32).reshape(10, 1)
    items = list(host_index_iterator(10, 4, shuffle=False, drop_last=False))
    assert len(items) == 3
    for idx, mask in items[:-1]:
        assert mask.all() and idx.dtype == np.int32
    idx, mask = items[-1]
    np.testing.assert_array_equal(mask, [True, True, False, False])
    np.testing.assert_array_equal(idx, [8, 9, 0, 0])

    batches = list(host_batch_iterator((x,), 4, shuffle=False,
                                       drop_last=False))
    for (row, m), (idx, mask) in zip(batches, items):
        np.testing.assert_array_equal(row, x[idx])
        np.testing.assert_array_equal(m, mask)


def test_synthetic_shapenet_boundary_jitter(tmp_path):
    """boundary_jitter=0 is bit-identical to the default fixture;
    jitter>0 changes labels ONLY (same clouds/categories), and only a
    minority of points flip (boundary-local)."""
    import h5py

    from adversarial_learning_on_pointclouds.data.shapenet_part import (
        make_synthetic_shapenet,
    )

    r0 = make_synthetic_shapenet(str(tmp_path / "a"), 32, 128)
    r1 = make_synthetic_shapenet(str(tmp_path / "b"), 32, 128,
                                 boundary_jitter=0.0)
    r2 = make_synthetic_shapenet(str(tmp_path / "c"), 32, 128,
                                 boundary_jitter=1.0)

    def load(root):
        with h5py.File(os.path.join(root, "ply_data_train0.h5")) as f:
            return (np.asarray(f["data"]), np.asarray(f["label"]),
                    np.asarray(f["pid"]))

    d0, l0, p0 = load(r0)
    d1, l1, p1 = load(r1)
    d2, l2, p2 = load(r2)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(d0, d2)   # same geometry
    np.testing.assert_array_equal(l0, l2)   # same categories
    frac = np.mean(p0 != p2)
    assert 0.0 < frac < 0.5, frac           # boundary-local flips only


def test_synthetic_shapenet_cluster_parts(tmp_path):
    """cluster_parts labels are blob membership: pids stay in the
    category's range, parts form separated clusters (intra-part spread
    well below inter-part centroid distance — the cluster-assumption
    regime), and per-shape center jitter makes the position->part map
    shape-specific (same-category shapes place part centroids apart)."""
    import h5py

    from adversarial_learning_on_pointclouds.data.shapenet_part import (
        CATEGORY_PART_RANGES, make_synthetic_shapenet,
    )

    r = make_synthetic_shapenet(str(tmp_path / "cl"), 48, 256,
                                cluster_parts=True)
    with h5py.File(os.path.join(r, "ply_data_train0.h5")) as f:
        d = np.asarray(f["data"])
        l = np.asarray(f["label"]).ravel()
        p = np.asarray(f["pid"])

    intra, inter = [], []
    cents_by_shape = []
    for i in range(len(d)):
        start, count = CATEGORY_PART_RANGES[l[i]]
        assert p[i].min() >= start and p[i].max() < start + count
        cents = {}
        for pid in np.unique(p[i]):
            m = p[i] == pid
            cents[pid] = d[i][m].mean(0)
            intra.append(np.linalg.norm(d[i][m] - cents[pid], axis=1).mean())
        cents_by_shape.append(cents)
        ks = sorted(cents)
        inter.extend(np.linalg.norm(cents[a] - cents[b])
                     for j, a in enumerate(ks) for b in ks[j + 1:])
    assert np.mean(inter) > 2.5 * np.mean(intra), (np.mean(inter),
                                                   np.mean(intra))

    bycat = {}
    for i in range(len(d)):
        bycat.setdefault(int(l[i]), []).append(i)
    a, b = next(v for v in bycat.values() if len(v) >= 2)[:2]
    pid0 = CATEGORY_PART_RANGES[l[a], 0]
    shift = np.linalg.norm(cents_by_shape[a][pid0] - cents_by_shape[b][pid0])
    assert shift > 0.02, shift


# ---------------------------------------------------------------------------
# In-memory fixtures: the same arrays the on-disk fixtures hold
# ---------------------------------------------------------------------------

def test_synthetic_modelnet_arrays_match_h5_fixture(tmp_path):
    from adversarial_learning_on_pointclouds.data import (
        ModelNet40, make_synthetic_modelnet_h5, synthetic_modelnet_arrays,
    )

    root = make_synthetic_modelnet_h5(str(tmp_path), 10, 6, 32, seed=3)
    train, test = synthetic_modelnet_arrays(10, 6, 32, seed=3)
    for mem, split in ((train, "train"), (test, "test")):
        disk = ModelNet40(root, split)
        np.testing.assert_array_equal(mem.points, disk.points)
        np.testing.assert_array_equal(mem.labels, disk.labels)


@pytest.mark.parametrize("layout", ["h5", "pts"])
def test_synthetic_shapenet_matches_written_fixture(tmp_path, layout):
    from adversarial_learning_on_pointclouds.data import synthetic_shapenet

    root = make_synthetic_shapenet(str(tmp_path), num_shapes=16,
                                   num_points=24, seed=5, layout=layout)
    mem = synthetic_shapenet(num_shapes=16, num_points=24, seed=5)
    for split in ("train", "test"):
        disk = ShapeNetPart(root, split)
        np.testing.assert_array_equal(mem[split].category, disk.category)
        pts, seg, _ = disk.as_arrays(24)
        if layout == "h5":   # exact arrays; pts text is rounded to 1e-6
            np.testing.assert_array_equal(mem[split].points, pts)
            np.testing.assert_array_equal(mem[split].part_labels, seg)
        else:                # the native loader resamples the point order
            assert pts.shape == mem[split].points.shape
            assert set(np.unique(seg)) <= set(np.unique(
                mem[split].part_labels))
