"""The gallery side of the port's serving engine against nope_tpu's:
``estimate_many``, int8 banks and the ``.npz`` bank registry read and
written by both packages (CPU: the ops run their plain versions)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.serving import PoseEstimator as JaxPoseEstimator
from nope_tpu.tasks.pose_conditional import PoseConditionalTask as JaxTask
from nope_tpu.tasks.pose_conditional import TaskConfig as JaxTaskConfig
from nope_tpu_torch.serving import PoseEstimator
from nope_tpu_torch.serving.engine import dequantize_bank, quantize_bank
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig
from tests.torch_port_helpers import IMG, UNET, VAE, seeded_port_modules

OBJECTS = ("mug", "cup", "can")


def _images(seed, n):
    return np.random.default_rng(seed).uniform(-1, 1, (n, IMG, IMG, 3)).astype(np.float32)


REFS = _images(1, 3)
REF_POSES = None  # the canonical grid pose
QUERIES = _images(2, 8)
QUERY_IDS = ["cup", "mug", "can", "cup", "can", "mug", "mug", "cup"]


@pytest.fixture(scope="module")
def gallery(tmp_path_factory):
    """The same seeded weights in both packages; a JAX int8 estimator with
    the three objects registered, its registry on disk and its answers."""
    unet, vae, params = seeded_port_modules(31)
    jtask = JaxTask(JaxPoseUNet(**UNET), JaxVAE(**VAE), JaxTaskConfig(half_precision_eval=False))
    path = str(tmp_path_factory.mktemp("registry") / "jax_int8.npz")
    with jax.default_matmul_precision("highest"):
        jest = JaxPoseEstimator(jtask, params, fast_evaluation=True, bank_dtype="int8")
        jest.register_objects(list(OBJECTS), REFS)
        jest.save_registry(path)
        many = jest.estimate_many(QUERY_IDS, QUERIES)
    task = PoseConditionalTask(unet, vae, TaskConfig(half_precision_eval=False))
    return dict(jtask=jtask, params=params, task=task, jest=jest, jax_path=path, jax_many=many)


def _port(gallery, **kw):
    est = PoseEstimator(gallery["task"], fast_evaluation=True, **kw)
    est.register_objects(list(OBJECTS), REFS)
    return est


def test_int8_banks_match_jax(gallery):
    est = _port(gallery, bank_dtype="int8")
    for i, oid in enumerate(OBJECTS):
        q8, scale = est._banks[oid]
        jq8, jscale = (np.asarray(a) for a in gallery["jest"]._banks[oid])
        assert q8.dtype == torch.int8 and q8.shape == (1, 26, IMG // 8, IMG // 8, 4)
        assert scale.dtype == torch.float32 and scale.shape == (1, 26, 1, 1, 4)
        # banks agree to the U-Net's tolerance: at most one step of the grid
        assert np.abs(q8.numpy().astype(np.int32).reshape(1, 26, -1) - jq8.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(scale.numpy().reshape(1, -1), jscale, rtol=1e-4)
    got = est.estimate_many(QUERY_IDS, QUERIES)
    np.testing.assert_array_equal(got.nearest_idx[:, 0], gallery["jax_many"].nearest_idx[:, 0])


def test_quantize_rounds_half_to_even_in_float32():
    bank = torch.tensor([127.0, 0.5, 1.5, -2.5, 63.5, -127.0]).reshape(1, 1, 1, 6, 1)
    q8, scale = quantize_bank(bank)
    assert scale.item() == 1.0
    assert q8.flatten().tolist() == [127, 0, 2, -2, 64, -127]
    np.testing.assert_array_equal(dequantize_bank(q8, scale, torch.float32).flatten().numpy(),
                                  [127, 0, 2, -2, 64, -127])
    assert dequantize_bank(q8, scale, torch.bfloat16).dtype == torch.bfloat16


def test_jax_registry_loads_into_the_port(gallery):
    est = PoseEstimator(gallery["task"], fast_evaluation=True, bank_dtype="int8")
    est.load_registry(gallery["jax_path"])
    assert sorted(est._banks) == sorted(OBJECTS)
    assert est._ref_latents["cup"].shape == (1, IMG // 8, IMG // 8, 4)
    assert est._bank_reps["cup"].shape == (26, 6)
    got = est.estimate_many(QUERY_IDS, QUERIES)
    want = gallery["jax_many"]
    # the same banks; the queries' encodes agree to the VAE's tolerance
    np.testing.assert_allclose(got.similarity, want.similarity, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.nearest_idx, want.nearest_idx)
    np.testing.assert_allclose(got.relative_rotations, want.relative_rotations, atol=1e-6)
    with pytest.raises(ValueError, match="bank_dtype"):
        PoseEstimator(gallery["task"], fast_evaluation=True).load_registry(gallery["jax_path"])
    with pytest.raises(ValueError, match="template grid"):
        PoseEstimator(gallery["task"], bank_dtype="int8").load_registry(gallery["jax_path"])


def test_port_registry_loads_into_jax_and_estimate_many_matches(gallery, tmp_path):
    est = _port(gallery)
    path = str(tmp_path / "port.npz")
    est.save_registry(path)
    with jax.default_matmul_precision("highest"):
        jest = JaxPoseEstimator(gallery["jtask"], gallery["params"], fast_evaluation=True)
        jest.load_registry(path)
        want = jest.estimate_many(QUERY_IDS, QUERIES)
    got = est.estimate_many(QUERY_IDS, QUERIES)
    assert got.similarity.shape == (8, 26) and got.nearest_idx.shape == (8, 5)
    np.testing.assert_allclose(got.similarity, want.similarity, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.nearest_idx, want.nearest_idx)
    np.testing.assert_allclose(got.relative_rotations, want.relative_rotations, atol=1e-6)
    for oid in OBJECTS:  # reference latents and conditioning reps ride along
        np.testing.assert_array_equal(np.asarray(jest._ref_latents[oid]).reshape(1, IMG // 8, IMG // 8, 4),
                                      est._ref_latents[oid].numpy())
        np.testing.assert_array_equal(np.asarray(jest._bank_reps[oid]).reshape(26, 6), est._bank_reps[oid].numpy())


def test_estimate_many_rows_equal_estimate(gallery):
    est = _port(gallery)
    many = est.estimate_many(QUERY_IDS, QUERIES)
    for oid in OBJECTS:
        rows = [i for i, o in enumerate(QUERY_IDS) if o == oid]
        one = est.estimate(oid, QUERIES[rows])
        # a bank per query against one shared bank: float32 sums in another order
        np.testing.assert_allclose(many.similarity[rows], one.similarity, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(many.nearest_idx[rows], one.nearest_idx)
    with pytest.raises(ValueError, match="object ids"):
        est.estimate_many(QUERY_IDS[:3], QUERIES)
    with pytest.raises(KeyError, match="plate"):
        est.estimate_many(["plate"] * 8, QUERIES)


def test_stacked_bank_cache_follows_the_gallery(gallery, tmp_path):
    est = _port(gallery)
    est.estimate_many(QUERY_IDS, QUERIES)
    key, stacked = est._stacked_cache
    assert key == ("cup", "mug", "can") and stacked.shape == (3, 26, IMG // 8, IMG // 8, 4)
    est.estimate_many(QUERY_IDS, QUERIES)
    assert est._stacked_cache[1] is stacked  # reused while the gallery stands
    est.register_object("cup", REFS[0])  # re-registered with another image
    assert est._stacked_cache == (None, None)
    after = est.estimate_many(QUERY_IDS, QUERIES)
    np.testing.assert_allclose(after.similarity[[1]], est.estimate("mug", QUERIES[[1]]).similarity, rtol=1e-5)
    np.testing.assert_allclose(after.similarity[[0]], est.estimate("cup", QUERIES[[0]]).similarity, rtol=1e-5)
    est.deregister_object("can")
    assert est._stacked_cache == (None, None)
    with pytest.raises(KeyError):
        est.estimate_many(QUERY_IDS, QUERIES)
    est.estimate_many(["cup", "mug"], QUERIES[:2])
    path = str(tmp_path / "two.npz")
    est.save_registry(path)
    est.load_registry(path)
    assert est._stacked_cache == (None, None)


@pytest.mark.parametrize("dim,convert,back", [(6, "matrix_to_rotation_6d", "rotation_6d_to_matrix"),
                                              (4, "matrix_to_quaternion", "quaternion_to_matrix"),
                                              (3, "matrix_to_euler_angles", "euler_angles_to_matrix")])
def test_bank_conditioning_in_each_representation(dim, convert, back):
    """A U-Net conditioned on rotation-6d, quaternions or Euler XYZ gets its
    bank's ΔR in that representation, as nope_tpu's engine makes them.
    The grid holds ΔRs at Euler XYZ's gimbal lock, where the angles are
    ill-conditioned in float32 in both packages: those rows are left out."""
    from nope_tpu_torch.geometry import rotations as rot
    from nope_tpu.geometry import rotations as jrot
    from nope_tpu.geometry.transforms import relative_rotation_jax
    from nope_tpu_torch.models.factory import init_weights
    from nope_tpu_torch.models.unet import PoseUNet
    from nope_tpu_torch.models.vae import StableDiffusionVAE

    gen = torch.Generator().manual_seed(dim)
    unet = init_weights(PoseUNet(**UNET, rot_representation_dim=dim), gen).eval()
    vae = init_weights(StableDiffusionVAE(**VAE), gen).eval()
    est = PoseEstimator(PoseConditionalTask(unet, vae, TaskConfig(half_precision_eval=False)), fast_evaluation=True)
    ref_pose = est.template_poses[5]
    est.register_object("mug", REFS[0], ref_pose)
    rel = relative_rotation_jax(est.template_poses, np.broadcast_to(ref_pose, est.template_poses.shape))
    reps = est._bank_reps["mug"]
    want = np.asarray(getattr(jrot, convert)(rel, "XYZ") if dim == 3 else getattr(jrot, convert)(rel))
    rows = np.abs(np.abs(want[:, 1]) - np.pi / 2) > 1e-2 if dim == 3 else np.ones(len(want), bool)
    assert rows.sum() >= 20
    np.testing.assert_allclose(reps.numpy()[rows], want[rows], atol=1e-5)
    again = rot.euler_angles_to_matrix(reps, "XYZ") if dim == 3 else getattr(rot, back)(reps)
    np.testing.assert_allclose(again.numpy()[rows], np.asarray(rel)[rows], atol=1e-5)
    assert np.isfinite(est.estimate("mug", QUERIES[:2]).similarity).all()


def test_bf16_registry_round_trip_is_bitwise(gallery, tmp_path):
    task = dataclasses.replace(gallery["task"].config, half_precision_eval=True)
    task = PoseConditionalTask(gallery["task"].unet, gallery["task"].vae, task)
    est = PoseEstimator(task, fast_evaluation=True)
    est.register_objects(list(OBJECTS), REFS)
    before = est.estimate("mug", QUERIES[:3])
    path = str(tmp_path / "bf16.npz")
    est.save_registry(path)
    fresh = PoseEstimator(task, fast_evaluation=True)
    fresh.load_registry(path)
    assert fresh._banks["mug"].dtype == torch.bfloat16
    after = fresh.estimate("mug", QUERIES[:3])
    np.testing.assert_array_equal(after.similarity, before.similarity)
    np.testing.assert_array_equal(after.nearest_idx, before.nearest_idx)
    # int8 through a fresh estimator, bitwise too
    est8 = PoseEstimator(task, fast_evaluation=True, bank_dtype="int8")
    est8.register_objects(list(OBJECTS), REFS)
    est8.save_registry(path)
    fresh8 = PoseEstimator(task, fast_evaluation=True, bank_dtype="int8")
    fresh8.load_registry(path)
    np.testing.assert_array_equal(fresh8.estimate_many(QUERY_IDS, QUERIES).similarity,
                                  est8.estimate_many(QUERY_IDS, QUERIES).similarity)
