"""The port's host geometry against ``nope_tpu``'s on the same seeded
inputs: the numpy halves of ``geometry/transforms.py`` (float64, 1e-12
or equal), the template-id map, ``icosphere`` and ``generate_so3_grid``
(equal; levels 0-1 against the assets as sets), ``NearestTemplateFinder``
(indices equal, in-plane angles within 1e-9 deg), and
``scripts/find_neighbors.py`` reproducing the port's assets bitwise."""

import os

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from nope_tpu.geometry import so3_grid as jgrid
from nope_tpu.geometry import transforms as jtf
from nope_tpu_torch.geometry import so3_grid, transforms
from nope_tpu_torch.scripts import find_neighbors

TOL = 1e-12


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = Rotation.random(n, random_state=seed).as_matrix()
    poses[:, :3, 3] = rng.normal(size=(n, 3)) * 100.0
    return poses


def test_numpy_transforms_match():
    poses = _poses(16, 0)
    np.testing.assert_array_equal(transforms.opencv2opengl_numpy(poses), jtf.opencv2opengl(poses))
    np.testing.assert_array_equal(transforms.inverse_transform_numpy(poses), jtf.inverse_transform(poses))
    for p, q in zip(poses[:-1], poses[1:]):
        np.testing.assert_array_equal(transforms.inverse_transform_numpy(p), jtf.inverse_transform(p))
        np.testing.assert_array_equal(transforms.combine_R_and_T(p[:3, :3], p[:3, 3], 0.001),
                                      jtf.combine_R_and_T(p[:3, :3], p[:3, 3], 0.001))
        np.testing.assert_array_equal(transforms.relative_rotation_numpy(p, q), jtf.relative_rotation(p, q))
        assert transforms.geodesic_numpy(p[:3, :3], q[:3, :3]) == jtf.geodesic_numpy(p[:3, :3], q[:3, :3])
        assert abs(transforms.extract_inplane_from_pose(p[:3, :3]) - jtf.extract_inplane_from_pose(p[:3, :3])) <= TOL
        assert abs(transforms.compute_inplane(p[:3, :3], q[:3, :3], warn_deg=360.0)
                   - jtf.compute_inplane(p[:3, :3], q[:3, :3], warn_deg=360.0)) <= TOL
        np.testing.assert_allclose(transforms.adding_inplane_to_pose(p[:3, :3], 17.5),
                                   jtf.adding_inplane_to_pose(p[:3, :3], 17.5), rtol=0, atol=TOL)
    rng = np.random.default_rng(1)
    locs = rng.normal(size=(8, 3))
    for loc in locs:
        np.testing.assert_allclose(transforms.look_at(loc, np.zeros(3)), jtf.look_at(loc, np.zeros(3)), rtol=0,
                                   atol=TOL)
    np.testing.assert_array_equal(transforms.look_at(np.array([0.0, 0.0, 1.0]), np.zeros(3)),
                                  jtf.look_at(np.array([0.0, 0.0, 1.0]), np.zeros(3)))  # the pole fallback
    az, el, r = rng.uniform(0, 2 * np.pi, 8), rng.uniform(0, np.pi, 8), rng.uniform(0.5, 2, 8)
    xyz = transforms.spherical_to_cartesian(az, el, r)
    np.testing.assert_array_equal(xyz, jtf.spherical_to_cartesian(az, el, r))
    for got, want in zip(transforms.cartesian_to_spherical(*xyz.T), jtf.cartesian_to_spherical(*xyz.T)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(transforms.normalize(locs), jtf.normalize(locs))
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    pose = _poses(1, 2)[0]
    pose[:3, 3] = [0, 0, 800]
    pts = rng.normal(size=(32, 3)) * 50
    np.testing.assert_array_equal(transforms.perspective(K, pose, pts), jtf.perspective(K, pose, pts))


@pytest.mark.parametrize("level, dist", [(0, "upper"), (2, "upper"), (1, "all")])
def test_template_id_mapping_matches(level, dist):
    assert (so3_grid.load_mapping_id_templates_to_idx_pose_distribution(level, dist)
            == jgrid.load_mapping_id_templates_to_idx_pose_distribution(level, dist))


def test_icosphere_matches():
    for s in range(4):
        got, want = so3_grid.icosphere(s), jgrid.icosphere(s)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(so3_grid.icosahedron()[0], jgrid.icosahedron()[0])


@pytest.mark.parametrize("level", [0, 1])
def test_generated_grid_matches(level):
    """Equal to JAX's generator, and the assets' camera locations and
    object poses as sets (in-ring ties may order differently)."""
    cam, obj = so3_grid.generate_so3_grid(level)
    jcam, jobj = jgrid.generate_so3_grid(level)
    np.testing.assert_array_equal(cam, jcam)
    np.testing.assert_array_equal(obj, jobj)
    ref_cam, ref_obj = so3_grid.load_cam_poses(level), so3_grid.load_obj_poses(level)
    d2 = np.sum((cam[:, None, :3, 3] - ref_cam[None, :, :3, 3]) ** 2, axis=-1)
    nearest = np.argmin(d2, axis=1)
    assert sorted(nearest.tolist()) == list(range(len(ref_cam)))
    assert d2[np.arange(len(cam)), nearest].max() < 1e-10
    np.testing.assert_allclose(obj[:, :3, 3], ref_obj[nearest][:, :3, 3], atol=1e-6)


@pytest.mark.parametrize("dist", ["all", "upper"])
def test_nearest_template_finder_matches(dist):
    """Seeded random poses, grid poses (exact hits) and grid poses with an
    in-plane turn: indices equal, in-plane angles within 1e-9 deg."""
    poses = np.concatenate([_poses(40, 3), so3_grid.load_obj_poses(2)[::37]])
    turned = so3_grid.get_obj_poses_from_template_level(2, "upper")[5::23].copy()  # in both distributions
    turned[:, :3, :3] = np.stack([transforms.adding_inplane_to_pose(p[:3, :3], 23.0) for p in turned])
    poses = np.concatenate([poses, turned])
    finder = so3_grid.NearestTemplateFinder(2, dist, return_inplane=True)
    jfinder = jgrid.NearestTemplateFinder(2, dist, return_inplane=True)
    idx, inplane = finder.search_nearest_template(poses)
    jidx, jinplane = jfinder.search_nearest_template(poses)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(inplane, jinplane, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(so3_grid.NearestTemplateFinder(2, dist).search_nearest_template(poses),
                                  jgrid.NearestTemplateFinder(2, dist).search_nearest_template(poses))
    np.testing.assert_allclose(inplane[-len(turned):], 23.0, atol=1e-6)


def test_nearest_template_finder_ties_take_the_first():
    """A direction equidistant from two templates goes to the first of
    them, as ``np.argmin`` does in JAX's finder."""
    finder = so3_grid.NearestTemplateFinder(0, "all")
    gl = finder.obj_template_openGL_poses[:, 2, :3]
    a, b = 0, int(np.argsort(np.sum((gl - gl[0]) ** 2, axis=1))[1])
    mid = transforms.normalize(gl[a] + gl[b])
    pose = np.eye(4)
    pose[2, :3] = -mid  # row 2 of the OpenGL pose is minus the OpenCV row
    pose[0, :3] = transforms.normalize(np.cross([0.3, 0.1, 0.9], mid))
    pose[1, :3] = np.cross(pose[2, :3], pose[0, :3])
    got = finder.search_nearest_template(pose)
    assert got == jgrid.NearestTemplateFinder(0, "all").search_nearest_template(pose)
    assert got[0] in (a, b)


def test_find_neighbors_reproduces_the_assets(tmp_path, capsys):
    assert find_neighbors.main(["--out-dir", str(tmp_path)]) == {"all": True, "upper": True}
    assets = os.path.join(os.path.dirname(so3_grid.__file__), "assets")
    for dist in ("all", "upper"):
        name = f"idx_{dist}_level0_in_level2.npy"
        assert (tmp_path / name).read_bytes() == open(os.path.join(assets, name), "rb").read()
    assert "matches committed asset: True" in capsys.readouterr().out
