"""Recompute the level0→level2 nearest-template index maps
(``nope_tpu/scripts/find_neighbors.py``).

Locates each level-0 grid pose inside the level-2 grid with
:class:`~nope_tpu_torch.geometry.so3_grid.NearestTemplateFinder` and
compares the result with ``idx_{all,upper}_level0_in_level2.npy`` in
``nope_tpu_torch/geometry/assets/``; with ``--out-dir`` it writes them
there (the committed files were made this way)::

    python -m nope_tpu_torch.scripts.find_neighbors [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nope_tpu_torch.geometry.so3_grid import (
    NearestTemplateFinder,
    get_obj_poses_from_template_level,
    load_index_level0_in_level2,
)


def compute(pose_distribution: str = "all") -> np.ndarray:
    finder = NearestTemplateFinder(level_templates=2, pose_distribution="all", return_inplane=False)
    obj_level0 = get_obj_poses_from_template_level(0, pose_distribution)
    return finder.search_nearest_template(obj_level0)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out-dir", default=None)
    args = parser.parse_args(argv)
    matches = {}
    for dist in ("all", "upper"):
        idx = compute(dist)
        matches[dist] = bool(np.array_equal(idx, load_index_level0_in_level2(dist)))
        print(f"{dist}: {len(idx)} indices, matches committed asset: {matches[dist]}")
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            np.save(os.path.join(args.out_dir, f"idx_{dist}_level0_in_level2.npy"), idx)
    return matches


if __name__ == "__main__":
    main()
