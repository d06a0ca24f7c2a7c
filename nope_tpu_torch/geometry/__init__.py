"""Pose geometry: SO(3) template grids, rotation-6d, relative rotations."""

from nope_tpu_torch.geometry import rotations, so3_grid, transforms  # noqa: F401
