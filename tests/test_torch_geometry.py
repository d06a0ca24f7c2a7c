"""nope_tpu_torch.geometry against nope_tpu.geometry: grid loaders, 6d
round trips and relative rotations (exact float32 math on both sides)."""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nope_tpu.geometry import rotations as jrot
from nope_tpu.geometry import so3_grid as jgrid
from nope_tpu.geometry import transforms as jtf
from nope_tpu_torch.geometry import rotations, so3_grid, transforms

torch.set_num_threads(1)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("dist", ["all", "upper"])
def test_grid_loaders_match(level, dist):
    idx_t, poses_t = so3_grid.get_obj_poses_from_template_level(level, dist, return_index=True)
    idx_j, poses_j = jgrid.get_obj_poses_from_template_level(level, dist, return_index=True)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(poses_t, poses_j)
    np.testing.assert_array_equal(
        so3_grid.get_obj_poses_from_template_level(level, dist, return_cam=True),
        jgrid.get_obj_poses_from_template_level(level, dist, return_cam=True),
    )


@pytest.mark.parametrize("dist", ["all", "upper"])
def test_level0_in_level2_index_matches(dist):
    np.testing.assert_array_equal(
        so3_grid.load_index_level0_in_level2(dist), jgrid.load_index_level0_in_level2(dist)
    )
    assert len(so3_grid.load_index_level0_in_level2("upper")) == 26


def test_assets_are_the_jax_package_files():
    """The port reads its own copy of the grids, byte for byte the JAX
    package's, and nothing under nope_tpu/."""
    port = Path(so3_grid._ASSET_DIR)
    jax_dir = Path(jgrid.__file__).resolve().parent / "assets" / "predefined_poses"
    names = sorted(p.name for p in jax_dir.glob("*.npy"))
    assert names and names == sorted(p.name for p in port.glob("*.npy"))
    for name in names:
        assert (port / name).read_bytes() == (jax_dir / name).read_bytes(), name
    assert Path(__file__).resolve().parents[1] / "nope_tpu" not in port.resolve().parents


def test_unknown_distribution_raises():
    with pytest.raises(ValueError, match="pose_distribution"):
        so3_grid.get_obj_poses_from_template_level(0, "lower")


def test_rotation_6d_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    d6 = rng.normal(size=(7, 5, 6)).astype(np.float32)
    m_t = rotations.rotation_6d_to_matrix(torch.from_numpy(d6)).numpy()
    m_j = np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(d6)))
    # elementwise float32 math on both sides; 1e-6 covers sqrt/division
    # rounding in a different evaluation order
    np.testing.assert_allclose(m_t, m_j, atol=1e-6)
    back_t = rotations.matrix_to_rotation_6d(torch.from_numpy(m_t)).numpy()
    np.testing.assert_array_equal(back_t, np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(m_t))))
    # 6d of a rotation is a fixed point of the round trip, up to the
    # float32 rounding of renormalising an already unit-norm row
    np.testing.assert_allclose(
        rotations.rotation_6d_to_matrix(torch.from_numpy(back_t)).numpy(), m_t, atol=5e-6
    )


def test_relative_rotation_matches_jax():
    grid = so3_grid.get_obj_poses_from_template_level(2, "upper")[:, :3, :3].astype(np.float32)
    ref = grid[[0, 17, 200]]
    rel_t = transforms.relative_rotation(
        torch.from_numpy(grid)[None], torch.from_numpy(ref)[:, None]
    ).numpy()
    rel_j = np.asarray(jtf.relative_rotation_jax(jnp.asarray(grid)[None], jnp.asarray(ref)[:, None]))
    assert rel_t.shape == (3, 341, 3, 3)
    np.testing.assert_allclose(rel_t, rel_j, atol=1e-6)
