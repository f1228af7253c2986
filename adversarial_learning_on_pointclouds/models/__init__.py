"""Model zoo: PointNet family + point-wise FCN discriminator.

Functional (init/apply) modules over plain pytrees. Architecture parity
with the reference's ``upstream:pointnet/model.py`` and
``upstream:model/discriminator.py`` (SURVEY.md §2.3-2.4); numerics locked
by the torch-CPU golden tests in ``tests/test_torch_parity.py``.
"""

from adversarial_learning_on_pointclouds.models.tnet import (  # noqa: F401
    init_tnet, apply_tnet, apply_tnet_pair,
)
from adversarial_learning_on_pointclouds.models.encoder import (  # noqa: F401
    init_encoder, apply_encoder, apply_encoder_parts,
    apply_encoder_parts_pair,
)
from adversarial_learning_on_pointclouds.models.classifier import (  # noqa: F401
    init_classifier, apply_classifier,
)
from adversarial_learning_on_pointclouds.models.segmenter import (  # noqa: F401
    init_segmenter, apply_segmenter, apply_segmenter_pair,
)
from adversarial_learning_on_pointclouds.models.discriminator import (  # noqa: F401
    init_discriminator, apply_discriminator,
)
from adversarial_learning_on_pointclouds.models import core  # noqa: F401
