#!/usr/bin/env python
"""Render point clouds to PNG (headless matplotlib).

The reference lineage ships an interactive OpenGL viewer
(``upstream:utils/show3d_balls.py`` family — declared out of scope for a
headless environment in SURVEY.md §2.10); this is its offline
equivalent: scatter-render ``.ply`` exports (``utils/ply.py``), raw
``.pts`` files, or shapes out of a dataset root, colored by part label
when labels are present.

  python scripts/render_cloud.py --ply out_ply/shape_0003.ply --out s3.png
  python scripts/render_cloud.py --dataset /data/shapenet --index 7 --out s7.png
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _render(points, labels, out: str, elev: float, azim: float) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6), dpi=120)
    ax = fig.add_subplot(projection="3d")
    kw = {}
    if labels is not None:
        kw = {"c": labels, "cmap": "tab20"}
    ax.scatter(points[:, 0], points[:, 2], points[:, 1], s=2, **kw)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    ax.set_box_aspect((1, 1, 1))
    fig.tight_layout(pad=0)
    fig.savefig(out)
    plt.close(fig)


def main():
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ply", type=str, help=".ply file (utils/ply.py)")
    src.add_argument("--pts", type=str, help="raw .pts file (x y z rows)")
    src.add_argument("--dataset", type=str,
                     help="ShapeNet-part root; renders --index")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--seg", type=str, default="",
                   help=".seg labels for --pts coloring")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--elev", type=float, default=20.0)
    p.add_argument("--azim", type=float, default=-60.0)
    a = p.parse_args()

    import numpy as np

    labels = None
    if a.ply:
        from adversarial_learning_on_pointclouds.utils import ply
        points = ply.read_ply(a.ply)  # xyz; label colors baked in the file
    elif a.pts:
        points = np.loadtxt(a.pts, dtype=np.float32).reshape(-1, 3)
        if a.seg:
            labels = np.loadtxt(a.seg, dtype=np.int32)
    else:
        from adversarial_learning_on_pointclouds.data import ShapeNetPart
        ds = ShapeNetPart(a.dataset, "train")
        points, labels, _ = ds[a.index]
    _render(np.asarray(points), labels, a.out, a.elev, a.azim)
    print(f"wrote {a.out} ({len(points)} points)")


if __name__ == "__main__":
    main()
