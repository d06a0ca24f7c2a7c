"""Refinement on the port's user paths against ``nope_tpu``'s on the same
weights and inputs (CPU, float32, JAX at "highest" matmul precision):
``eval_geodesic_step(refine_steps=...)``, ``evaluate_geodesic``'s refined
scores and dumps, and ``PoseEstimator.estimate`` / ``estimate_many`` with
single- and multi-start refinement."""

import functools

import jax
import numpy as np
import pytest
import torch

from nope_tpu.evaluation.geodesic import evaluate_geodesic as jax_evaluate_geodesic
from nope_tpu.geometry import rotations as jrot
from nope_tpu.geometry import transforms as jtf
from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.serving import PoseEstimator as JaxPoseEstimator
from nope_tpu.tasks.pose_conditional import PoseConditionalTask as JaxTask
from nope_tpu.tasks.pose_conditional import TaskConfig as JaxTaskConfig
from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic
from nope_tpu_torch.geometry import so3_grid
from nope_tpu_torch.geometry.rotations import matrix_to_rotation_6d, rotation_6d_to_matrix
from nope_tpu_torch.serving import PoseEstimator
from nope_tpu_torch.tasks import refinement as ref
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig
from tests.torch_port_helpers import IMG, UNET, VAE, seeded_port_modules

HI = functools.partial(jax.default_matmul_precision, "highest")
N_GRID = 8


@pytest.fixture(scope="module")
def models():
    unet, vae, params = seeded_port_modules(41)
    jtask = JaxTask(JaxPoseUNet(**UNET), JaxVAE(**VAE), JaxTaskConfig(half_precision_eval=False))
    task = PoseConditionalTask(unet, vae, TaskConfig(half_precision_eval=False))
    return jtask, params, task


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, n):
    return np.random.default_rng(seed).uniform(-1, 1, (n, IMG, IMG, 3)).astype(np.float32)


def _assert_well_posed(task, q_lat, r_lat, init_R):
    """The refinement tests' precondition: no component of the initial
    gradient below 1e-3 of its row's max|g| (Adam's first step is close
    to lr·sign(g), so such a component would test rounding)."""
    leaf = matrix_to_rotation_6d(init_R).float().requires_grad_(True)
    with ref.frozen(task.unet):
        d = ref._per_sample_objective("l2")(task.predict_latent(r_lat, leaf).float(), q_lat.float())
        (g,) = torch.autograd.grad(d.sum(), leaf)
    g = g.abs()
    assert (g >= 1e-3 * g.amax(1, keepdim=True)).all(), g


def _eval_batch(seed, b):
    """Grid poses, seeded images, off-grid queries, symmetry 0/1/2."""
    rng = np.random.default_rng(seed)
    grid = so3_grid.load_obj_poses(0)[:N_GRID, :3, :3].astype(np.float32)
    query_pose = grid[rng.integers(0, N_GRID, b)].copy()
    q = rng.normal(size=(b, 4)).astype(np.float32)
    with HI():
        query_pose[::2] = np.asarray(jrot.quaternion_to_matrix(q / np.linalg.norm(q, axis=-1, keepdims=True)))[::2]
        all_rel = np.asarray(jtf.relative_rotation_jax(np.broadcast_to(grid, (b, N_GRID, 3, 3)),
                                                       np.broadcast_to(grid[0], (b, N_GRID, 3, 3))))
        gt_rel = np.asarray(jtf.relative_rotation_jax(query_pose, np.broadcast_to(grid[0], (b, 3, 3))))
    return {
        "query": _images(seed + 1, b), "reference": _images(seed + 2, b),
        "gt_relativeR": np.asarray(jrot.matrix_to_rotation_6d(gt_rel)),
        "all_relativeR": np.asarray(jrot.matrix_to_rotation_6d(all_rel)),
        "query_pose": query_pose,
        "template_poses": np.ascontiguousarray(np.broadcast_to(grid, (b, N_GRID, 3, 3))),
        "symmetry": (np.arange(b) % 3).astype(np.int32),
    }


def _assert_batch_well_posed(task, tb, nearest):
    """The precondition at the eval step's inits, its retrieved top-1."""
    init = rotation_6d_to_matrix(tb["all_relativeR"][torch.arange(len(nearest)), nearest[:, 0]])
    _assert_well_posed(task, task.encode(tb["query"]), task.encode(tb["reference"]), init)


def test_eval_step_refinement_matches_jax(models):
    jtask, params, task = models
    batch = _eval_batch(90, 3)
    tb = {k: _t(v) for k, v in batch.items()}
    step = jax.jit(jtask.eval_geodesic_step, static_argnames=("chunk_size", "refine_steps", "refine_lr"))
    with HI():
        want = step(params, batch, chunk_size=4, refine_steps=3)
    plain = task.eval_geodesic_step(tb, chunk_size=4)
    got = task.eval_geodesic_step(tb, chunk_size=4, refine_steps=3)
    nearest = got["nearest_idx"]
    _assert_batch_well_posed(task, tb, nearest)
    assert set(got) == set(want) == set(plain) | {"refined_R", "refined_error_deg"}
    for key in plain:  # the grid outputs are those of the unrefined step
        assert torch.equal(torch.as_tensor(got[key]), torch.as_tensor(plain[key])), key
    np.testing.assert_array_equal(nearest.numpy(), np.asarray(want["nearest_idx"]))
    assert got["refined_R"].shape == (3, 3, 3) and got["refined_error_deg"].shape == (3,)
    np.testing.assert_allclose(got["refined_R"].numpy(), np.asarray(want["refined_R"]), atol=1e-4)
    # degrees from rotations within 1e-4: arccos near 0° magnifies, so 1e-2°
    np.testing.assert_allclose(got["refined_error_deg"].numpy(), np.asarray(want["refined_error_deg"]), atol=1e-2)
    rtr = torch.einsum("bji,bjk->bik", got["refined_R"], got["refined_R"])
    torch.testing.assert_close(rtr, torch.eye(3).expand(3, 3, 3), atol=1e-5, rtol=0)


def test_evaluate_geodesic_refined_scores_match_jax(models, tmp_path):
    """Batches of 3 and a ragged 2: the refined scores and the dumps'
    refined arrays."""
    jtask, params, task = models
    loader = [_eval_batch(95 + i, b) for i, b in enumerate((3, 2))]
    for batch in loader:
        tb = {k: _t(v) for k, v in batch.items()}
        _assert_batch_well_posed(task, tb, task.eval_geodesic_step(tb, chunk_size=4)["nearest_idx"])
    with HI():
        want = jax_evaluate_geodesic(jtask, params, loader, chunk_size=4, refine_steps=2,
                                     save_dir=str(tmp_path / "jax"))
    got = evaluate_geodesic(task, loader, chunk_size=4, refine_steps=2, save_dir=str(tmp_path / "port"))
    assert set(got) == set(want) and {"refined, accuracy_15", "refined, accuracy_30", "refined, median"} <= set(got)
    for key in want:
        if key != "images_per_sec":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-2, err_msg=key)
    for i in range(2):
        name = f"pred_eval_batch{i}_rank0.npz"
        with np.load(tmp_path / "port" / name) as a, np.load(tmp_path / "jax" / name) as b:
            assert a.files == b.files and "refined_R" in a.files and "refined_error_deg" in a.files
            np.testing.assert_allclose(a["refined_R"], b["refined_R"], atol=1e-4)
            assert a["refined_R"].shape == (3 - i, 3, 3)


@pytest.fixture(scope="module")
def estimators(models):
    jtask, params, task = models
    refs = _images(100, 2)
    with HI():
        jest = JaxPoseEstimator(jtask, params, fast_evaluation=True)
        jest.register_objects(["a", "b"], refs)
    est = PoseEstimator(task, fast_evaluation=True)
    est.register_objects(["a", "b"], refs)
    return jest, est


def _assert_starts_well_posed(est, oids, queries, result, topk):
    q_lat = est.task.encode(torch.from_numpy(queries))
    r_lat = torch.cat([est._ref_latents[o] for o in oids])
    reps = torch.stack([est._bank_reps[o] for o in oids])
    idx = torch.from_numpy(result.nearest_idx)
    for k in range(topk):
        _assert_well_posed(est.task, q_lat, r_lat, rotation_6d_to_matrix(reps[torch.arange(len(oids)), idx[:, k]]))


@pytest.mark.parametrize("topk", [1, 3])
def test_estimate_refinement_matches_jax(estimators, topk):
    jest, est = estimators
    queries = _images(101, 3)
    with HI():
        want = jest.estimate("a", queries, refine_steps=3, refine_topk=topk)
    plain = est.estimate("a", queries)
    got = est.estimate("a", queries, refine_steps=3, refine_topk=topk)
    _assert_starts_well_posed(est, ["a"] * 3, queries, got, topk)
    np.testing.assert_array_equal(got.nearest_idx, plain.nearest_idx)
    np.testing.assert_array_equal(got.similarity, plain.similarity)
    np.testing.assert_array_equal(got.nearest_idx, want.nearest_idx)
    assert plain.refined_relative_rotation is None and plain.refined_rotation is None
    np.testing.assert_allclose(got.refined_relative_rotation, want.refined_relative_rotation, atol=1e-4)
    np.testing.assert_allclose(got.refined_rotation, want.refined_rotation, atol=1e-4)
    assert got.refined_distance.shape == (3,) and np.isfinite(got.refined_distance).all()


@pytest.mark.parametrize("topk", [1, 3])
def test_estimate_many_refinement_matches_jax(estimators, topk):
    jest, est = estimators
    oids = ["b", "a", "b"]
    queries = _images(102, 3)
    with HI():
        want = jest.estimate_many(oids, queries, refine_steps=3, refine_topk=topk)
    got = est.estimate_many(oids, queries, refine_steps=3, refine_topk=topk)
    _assert_starts_well_posed(est, oids, queries, got, topk)
    np.testing.assert_array_equal(got.nearest_idx, want.nearest_idx)
    np.testing.assert_array_equal(got.similarity, est.estimate_many(oids, queries).similarity)
    np.testing.assert_allclose(got.refined_relative_rotation, want.refined_relative_rotation, atol=1e-4)
    np.testing.assert_allclose(got.refined_rotation, want.refined_rotation, atol=1e-4)
    # each query refines against its own object: query 1 alone equals estimate("a")
    one = est.estimate("a", queries[1:2], refine_steps=3, refine_topk=topk)
    np.testing.assert_allclose(got.refined_relative_rotation[1], one.refined_relative_rotation[0], atol=1e-5)


def test_refinement_needs_reference_latents(estimators, tmp_path):
    """An object from a registry without reference latents (one written
    before refinement existed) is refused with the JAX package's error."""
    _, est = estimators
    path = str(tmp_path / "gallery.npz")
    est.save_registry(path)
    with np.load(path) as data:
        kept = {k: data[k] for k in data.files if not k.startswith(("reflat:", "bankrep:"))}
    np.savez(path, **kept)
    fresh = PoseEstimator(est.task, fast_evaluation=True)
    fresh.load_registry(path)
    queries = _images(103, 1)
    assert fresh.estimate("a", queries).refined_relative_rotation is None
    with pytest.raises(ValueError, match="'a' was loaded from a registry without reference latents"):
        fresh.estimate("a", queries, refine_steps=1)
    with pytest.raises(ValueError, match=r"\['a'\] were loaded from a registry without reference latents"):
        fresh.estimate_many(["a"], queries, refine_steps=1)
