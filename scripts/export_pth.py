#!/usr/bin/env python
"""Export a framework checkpoint as a reference-format ``.pth``.

Migration back to the reference repo: translate a checkpoint's
params/BN state into a ``state_dict`` with the reference module names
(``utils/torch_export.py``) that ``model.load_state_dict(...,
strict=True)`` accepts.

  python scripts/export_pth.py --model cls_out --arch cls --out cls.pth
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, required=True,
                   help="checkpoint dir (as written by training)")
    p.add_argument("--arch", choices=("cls", "seg", "adv"), default="cls")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--num_classes", type=int, default=40)
    p.add_argument("--num_parts", type=int, default=50)
    p.add_argument("--feature_transform", action="store_true")
    a = p.parse_args()

    from adversarial_learning_on_pointclouds.configs import (
        AdversarialConfig, ClassifyConfig, SegmentConfig,
    )
    from adversarial_learning_on_pointclouds.train import (
        adversarial, classify, segment,
    )
    from adversarial_learning_on_pointclouds.utils import (
        checkpoint, torch_export,
    )

    if a.arch == "cls":
        cfg = ClassifyConfig(num_classes=a.num_classes,
                             feature_transform=a.feature_transform)
        state = checkpoint.restore(a.model, classify.create_state(cfg, 1))
        sd = torch_export.classifier_state_dict(state.params,
                                                state.bn_state)
    elif a.arch == "seg":
        cfg = SegmentConfig(num_parts=a.num_parts,
                            feature_transform=a.feature_transform)
        state = checkpoint.restore(a.model, segment.create_state(cfg, 1))
        sd = torch_export.segmenter_state_dict(state.params,
                                               state.bn_state)
    else:  # adversarial: export G (segmenter) and D side by side
        cfg = AdversarialConfig(num_parts=a.num_parts,
                                feature_transform=a.feature_transform)
        state = checkpoint.restore(a.model,
                                   adversarial.create_state(cfg, 1))
        sd = torch_export.segmenter_state_dict(state.g_params,
                                               state.g_bn_state)
        d_out = a.out.replace(".pth", "_D.pth")
        torch_export.save_pth(
            d_out, torch_export.discriminator_state_dict(state.d_params))
        print(f"wrote {d_out}")
    torch_export.save_pth(a.out, sd)
    print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
