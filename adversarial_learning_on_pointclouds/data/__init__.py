"""Data layer: HDF5/pts loaders, synthetic fixtures, on-device augmentation.

The reference does all of this per-sample in numpy on the CPU inside
``Dataset.__getitem__`` (``upstream:dataset.py`` / ``upstream:provider.py``,
SURVEY.md §2.1-2.2). Here the host side only reads raw arrays; the whole
normalize/resample/rotate/jitter/dropout chain is a single jitted
on-device function (``augment.augment_batch``) foldable into the train
step (``BASELINE.json:5`` "fused on-device preprocessing stage").
"""

from adversarial_learning_on_pointclouds.data import augment  # noqa: F401
from adversarial_learning_on_pointclouds.data.modelnet40 import (  # noqa: F401
    ModelNet40, make_synthetic_modelnet_h5, synthetic_modelnet_arrays,
)
from adversarial_learning_on_pointclouds.data.shapenet_part import (  # noqa: F401
    ShapeNetPart, SEG_CLASSES, make_synthetic_shapenet, synthetic_shapenet,
)
from adversarial_learning_on_pointclouds.data.loader import (  # noqa: F401
    batch_iterator,
)
