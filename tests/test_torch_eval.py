"""The evaluation program of the port against nope_tpu's on the same
weights and inputs (CPU: the ops run their plain versions): rotations
and transforms, the symmetry-aware metric, the Gaussian distribution,
the VAE decoder, the task's losses, streamed retrieval,
``eval_geodesic_step`` and ``evaluate_geodesic``."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nope_tpu.evaluation.geodesic import evaluate_geodesic as jax_evaluate_geodesic
from nope_tpu.geometry import rotations as jrot
from nope_tpu.geometry import transforms as jtf
from nope_tpu.models import distributions as jdist
from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.tasks.metrics import GeodesicError as JaxGeodesicError
from nope_tpu.tasks.pose_conditional import PoseConditionalTask as JaxTask
from nope_tpu.tasks.pose_conditional import TaskConfig as JaxTaskConfig
from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic
from nope_tpu_torch.geometry import rotations as rot
from nope_tpu_torch.geometry import so3_grid
from nope_tpu_torch.geometry import transforms as tf
from nope_tpu_torch.models import distributions as dist
from nope_tpu_torch.tasks.metrics import GeodesicError
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig
from tests.torch_port_helpers import IMG, UNET, VAE, seeded_port_modules

HI = functools.partial(jax.default_matmul_precision, "highest")
N_GRID = 8


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _j(f, *args, **kw):
    with HI():
        return np.array(f(*(jnp.asarray(a) for a in args), **kw))


def _random_rotations(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return _j(jrot.quaternion_to_matrix, q / np.linalg.norm(q, axis=-1, keepdims=True))


# -- rotations and transforms -------------------------------------------------

_R = _random_rotations(0, 64)
_Q = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
_AA = np.random.default_rng(2).normal(size=(64, 3)).astype(np.float32)
_AA[:4] *= 1e-7  # the small-angle branch
_EULER = np.random.default_rng(3).uniform(-1.5, 1.5, size=(64, 3)).astype(np.float32)
_POINTS = np.random.default_rng(4).normal(size=(64, 3)).astype(np.float32)
_T = np.concatenate([np.concatenate([_R, np.random.default_rng(5).normal(size=(64, 3, 1))], -1),
                     np.broadcast_to([[[0, 0, 0, 1]]], (64, 1, 4))], 1).astype(np.float32)

CASES = {
    "quaternion_to_matrix": (lambda m: m.quaternion_to_matrix, (_Q,)),
    "matrix_to_quaternion": (lambda m: m.matrix_to_quaternion, (_R,)),
    "standardize_quaternion": (lambda m: m.standardize_quaternion, (_Q,)),
    "quaternion_multiply": (lambda m: m.quaternion_multiply, (_Q, _Q[::-1].copy())),
    "quaternion_invert": (lambda m: m.quaternion_invert, (_Q,)),
    "quaternion_apply": (lambda m: m.quaternion_apply, (_Q / np.linalg.norm(_Q, axis=-1, keepdims=True), _POINTS)),
    "axis_angle_to_quaternion": (lambda m: m.axis_angle_to_quaternion, (_AA,)),
    "axis_angle_to_matrix": (lambda m: m.axis_angle_to_matrix, (_AA,)),
    "quaternion_to_axis_angle": (lambda m: m.quaternion_to_axis_angle, (_Q,)),
    "matrix_to_axis_angle": (lambda m: m.matrix_to_axis_angle, (_R,)),
    "euler_XYZ_to_matrix": (lambda m: functools.partial(m.euler_angles_to_matrix, convention="XYZ"), (_EULER,)),
    "euler_ZYZ_to_matrix": (lambda m: functools.partial(m.euler_angles_to_matrix, convention="ZYZ"), (_EULER,)),
    "matrix_to_euler_XYZ": (lambda m: functools.partial(m.matrix_to_euler_angles, convention="XYZ"), (_R,)),
    "matrix_to_euler_YXY": (lambda m: functools.partial(m.matrix_to_euler_angles, convention="YXY"), (_R,)),
    "matrix_to_euler_ZXY": (lambda m: functools.partial(m.matrix_to_euler_angles, convention="ZXY"), (_R,)),
    "so3_rotation_angle": (lambda m: m.so3_rotation_angle, (_R,)),
    "so3_relative_angle": (lambda m: m.so3_relative_angle, (_R, _R[::-1].copy())),
    "geodesic_distance": (lambda m: m.geodesic_distance, (_R, _R[::-1].copy())),
    "rotation_6d_to_matrix": (lambda m: m.rotation_6d_to_matrix, (_Q[:, :3].repeat(2, 1) + _AA.repeat(2, 1),)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rotations_match_jax(name):
    pick, args = CASES[name]
    want = _j(pick(jrot), *args)
    got = pick(rot)(*(_t(a) for a in args)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # float32 elementwise math in another order: a few ulps
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", ["opencv2opengl", "convert_openCV_to_openGL_rotation", "inverse_transform"])
def test_transforms_match_jax(name):
    jname = {"opencv2opengl": "opencv2opengl_jax", "inverse_transform": "inverse_transform_jax"}.get(name, name)
    arg = _T if name != "convert_openCV_to_openGL_rotation" else _R
    want = _j(getattr(jtf, jname), arg)
    got = getattr(tf, name)(_t(arg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_acos_extrapolation_near_the_bounds():
    x = np.concatenate([np.linspace(-1.0, 1.0, 101), 1.0 - np.logspace(-8, -3, 40), -1.0 + np.logspace(-8, -3, 40),
                        [1.0 + 1e-5, -1.0 - 1e-5]]).astype(np.float32)
    want = _j(jrot.acos_linear_extrapolation, x)
    got = rot.acos_linear_extrapolation(_t(x)).numpy()
    # near ±1 the extrapolated slope is ~70: a float32 ulp of x moves it ~1e-5
    np.testing.assert_allclose(got, want, atol=1e-5)
    inside = np.abs(x) < 1.0 - 1e-4
    np.testing.assert_allclose(got[inside], np.arccos(x[inside]), atol=1e-6)
    # the identity sits on the extrapolated line: pytorch3d's ~0.405° floor
    floor = np.arccos(1 - 1e-4) - 1e-4 / np.sqrt(1 - (1 - 1e-4) ** 2)
    np.testing.assert_allclose(rot.so3_rotation_angle(torch.eye(3)[None]).numpy(), [floor], rtol=1e-3)


def test_random_rotations_are_seeded_rotations():
    a = rot.random_rotations(500, torch.Generator().manual_seed(3))
    b = rot.random_rotations(500, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (500, 3, 3)
    eye = rot.matmul3(a, a.transpose(-1, -2))
    torch.testing.assert_close(eye, torch.eye(3).expand_as(eye), atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.linalg.det(a), torch.ones(500), atol=1e-5, rtol=0)
    # uniform on SO(3): the trace has mean 0 and variance 1
    trace = a.diagonal(dim1=-2, dim2=-1).sum(-1)
    assert abs(trace.mean().item()) < 0.15 and abs(trace.var().item() - 1.0) < 0.2


# -- the metric ---------------------------------------------------------------


@pytest.fixture(scope="module")
def metric_inputs():
    gt = _random_rotations(10, 10)
    pred = _random_rotations(11, 50).reshape(10, 5, 3, 3)
    pred[:3, 0] = gt[:3]  # exact matches: the extrapolated floor
    pred[3:6, 1] = gt[3:6] @ np.diag([-1.0, 1.0, -1.0]).astype(np.float32)  # flips that class 1 forgives
    symmetry = np.arange(10) % 3
    return pred, gt, symmetry


@pytest.mark.parametrize("topk", [1, 5])
def test_geodesic_error_matches_jax(metric_inputs, topk):
    pred, gt, symmetry = metric_inputs
    pred = pred[:, 0] if topk == 1 else pred
    with HI():
        jerr, jacc = JaxGeodesicError(thresholds=(15, 30))(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(symmetry))
    err, acc = GeodesicError(thresholds=(15, 30))(_t(pred), _t(gt), _t(symmetry))
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-4)
    assert set(acc) == set(jacc) and len(acc) == (3 if topk == 1 else 9)
    for key in acc:  # 10 errors: the lower of the two middle ones
        np.testing.assert_allclose(float(acc[key]), float(jacc[key]), atol=1e-4, err_msg=key)
    if topk == 5:
        with HI():
            want = JaxGeodesicError().topk_errors(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(symmetry))
        np.testing.assert_allclose(GeodesicError().topk_errors(_t(pred), _t(gt), _t(symmetry)).numpy(),
                                   np.asarray(want), atol=1e-4)


# -- distributions ------------------------------------------------------------


def test_distribution_matches_jax():
    rng = np.random.default_rng(12)
    p1, p2 = (rng.normal(size=(3, 4, 4, 8)).astype(np.float32) for _ in range(2))
    sample = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    jd1, jd2 = jdist.DiagonalGaussian.from_parameters(jnp.asarray(p1)), jdist.DiagonalGaussian.from_parameters(jnp.asarray(p2))
    d1, d2 = dist.DiagonalGaussian.from_parameters(_t(p1)), dist.DiagonalGaussian.from_parameters(_t(p2))
    for got, want in ((d1.kl(), jd1.kl()), (d1.kl(d2), jd1.kl(jd2)), (d1.nll(_t(sample)), jd1.nll(jnp.asarray(sample))),
                      (d1.std, jd1.std), (d1.var, jd1.var),
                      (dist.normal_kl(d1.mean, d1.logvar, d2.mean, d2.logvar),
                       jdist.normal_kl(jd1.mean, jd1.logvar, jd2.mean, jd2.logvar))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_distribution_sample_is_seeded_and_gaussian():
    mean, logvar = torch.full((4000, 2, 2, 4), 1.5), torch.full((4000, 2, 2, 4), np.log(0.25))
    d = dist.DiagonalGaussian(mean, logvar)
    a, b = d.sample(torch.Generator().manual_seed(7)), d.sample(torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and not torch.equal(a, d.sample(torch.Generator().manual_seed(8)))
    # 64000 draws of N(1.5, 0.5²): mean within ~6 standard errors, std within 2%
    assert abs(a.mean().item() - 1.5) < 0.012 and abs(a.std().item() - 0.5) < 0.01


# -- the task: decoder, losses, streaming, the eval step -----------------------


@pytest.fixture(scope="module")
def models():
    """Seeded port modules and the same weights as JAX params; a second
    U-Net with 2C outputs for the KL loss."""
    unet, vae, params = seeded_port_modules(21)
    kl_unet, _, kl_params = seeded_port_modules(22, out_dim=8)
    jtask = JaxTask(JaxPoseUNet(**UNET), JaxVAE(**VAE), JaxTaskConfig(half_precision_eval=False))
    return dict(jtask=jtask, params=params, kl_unet=JaxPoseUNet(**UNET, out_dim=8), kl_params=kl_params["unet"],
                unet=unet, vae=vae, port_kl_unet=kl_unet)


def _tasks(models, **cfg):
    """(JAX task, its params, port task) for one TaskConfig."""
    kl = cfg.get("loss_type") == "kl"
    jtask = JaxTask(models["kl_unet"] if kl else models["jtask"].unet, models["jtask"].vae,
                    JaxTaskConfig(**{"half_precision_eval": False, **cfg}))
    params = dict(models["params"], unet=models["kl_params"]) if kl else models["params"]
    task = PoseConditionalTask(models["port_kl_unet"] if kl else models["unet"], models["vae"],
                               TaskConfig(**{"half_precision_eval": False, **cfg}))
    return jtask, params, task


def _images(seed, n):
    return np.random.default_rng(seed).uniform(-1, 1, (n, IMG, IMG, 3)).astype(np.float32)


def test_decoder_matches_jax(models):
    lat = np.random.default_rng(13).normal(size=(2, IMG // 8, IMG // 8, 4)).astype(np.float32)
    jtask, params, task = _tasks(models)
    img, pose = _images(14, 2), np.random.default_rng(15).normal(size=(2, 6)).astype(np.float32)

    def jax_side(params, lat, img, pose):
        return (jtask.decode(params, lat), jtask.encode(params, img, None),
                jtask.sample(params, img, pose, decode_rgb=True))

    with HI():
        jdec, jd, (jpred, jrgb) = jax.jit(jax_side)(params, lat, img, pose)
    with torch.no_grad():
        got = task.decode(_t(lat)).numpy()
    assert got.shape == jdec.shape == (2, IMG, IMG, 3)
    # the repo's VAE parity tolerance (tests/test_vae_parity.py)
    np.testing.assert_allclose(got, np.asarray(jdec), atol=5e-5)
    # encode_image(mode=None): the distribution, its mean scaled
    d = task.encode(_t(img), None)
    np.testing.assert_allclose(d.mean.numpy(), np.asarray(jd.mean), atol=5e-5)
    np.testing.assert_allclose(d.logvar.numpy(), np.asarray(jd.logvar), atol=5e-5)
    pred, rgb = task.sample(_t(img), _t(pose), decode_rgb=True)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=5e-5)


def _loss_batch(seed, b=2):
    mats = _random_rotations(seed, b)
    return {"query": _images(seed + 1, b), "reference": _images(seed + 2, b),
            "relativeR": _j(jrot.matrix_to_rotation_6d, mats),
            "relativeR_inv": _j(jrot.matrix_to_rotation_6d, np.swapaxes(mats, -1, -2))}


@pytest.mark.parametrize("cfg", [dict(loss_type="l1"), dict(loss_type="l2", use_inv_deltaR=False),
                                 dict(loss_type="kl", using_KL=True)], ids=["l1", "l2_one_way", "kl"])
def test_losses_match_jax(models, cfg):
    """l1: both directions as one doubled batch; l2 one way (train_loss is
    forward_loss); kl: the two directions apart, against distribution
    targets.  JAX's multi_dataset_loss is the mean of its train_losses."""
    jtask, params, task = _tasks(models, **cfg)
    batches = {"a": _loss_batch(30), "b": _loss_batch(40)}
    with HI():
        train = jax.jit(jtask.train_loss)
        want = {name: float(train(params, b)) for name, b in batches.items()}
    tb = {name: {k: _t(v) for k, v in b.items()} for name, b in batches.items()}
    avg, losses = task.multi_dataset_loss(tb)
    np.testing.assert_allclose(avg.item(), (want["a"] + want["b"]) / 2, rtol=1e-4)
    for name in batches:
        np.testing.assert_allclose(losses[name].item(), want[name], rtol=1e-4)
    a = tb["a"]
    fwd = task.forward_loss(a["query"], a["reference"], a["relativeR"])
    if not task.config.use_inv_deltaR:
        np.testing.assert_allclose(fwd.item(), want["a"], rtol=1e-4)
    if task.config.using_KL:  # the mean of the two directions
        inv = task.forward_loss(a["reference"], a["query"], a["relativeR_inv"])
        np.testing.assert_allclose((fwd + inv).item() / 2, want["a"], rtol=1e-4)
    # differentiable on the CPU: the U-Net gets a gradient, the frozen VAE none
    task.unet.zero_grad(set_to_none=True)
    avg.backward()
    assert all(p.grad is not None for p in task.unet.parameters())
    assert all(p.grad is None for p in task.vae.parameters())
    task.unet.zero_grad(set_to_none=True)


def _eval_batch(seed, b, n=N_GRID):
    """Grid poses, seeded images, symmetry cycling 0/1/2 (as tests/test_task.py)."""
    rng = np.random.default_rng(seed)
    grid = so3_grid.load_obj_poses(0)[:n, :3, :3].astype(np.float32)
    gt_idx = rng.integers(0, n, b)
    query_pose = grid[gt_idx].copy()
    query_pose[::2] = _random_rotations(seed, b)[::2]  # off-grid queries too
    ref_pose = grid[0]
    all_rel = _j(jtf.relative_rotation_jax, np.broadcast_to(grid, (b, n, 3, 3)), np.broadcast_to(ref_pose, (b, n, 3, 3)))
    gt_rel = _j(jtf.relative_rotation_jax, query_pose, np.broadcast_to(ref_pose, (b, 3, 3)))
    return {
        "query": _images(seed + 1, b), "reference": _images(seed + 2, b),
        "gt_relativeR": _j(jrot.matrix_to_rotation_6d, gt_rel),
        "all_relativeR": _j(jrot.matrix_to_rotation_6d, all_rel),
        "query_pose": query_pose,
        "template_poses": np.ascontiguousarray(np.broadcast_to(grid, (b, n, 3, 3))),
        "symmetry": (np.arange(b) % 3).astype(np.int32),
    }


METRICS = ("l2", "l2_true", "cosine")


@pytest.fixture(scope="module")
def jax_streamed(models):
    """JAX's retrieve_streaming for the three metrics, one program."""
    batch = _eval_batch(50, 3)
    tasks = [_tasks(models, similarity_metric=m)[0] for m in METRICS]
    params = models["params"]

    def jax_side(params, q, r, rel):
        return [t.retrieve_streaming(params, q, r, rel, chunk_size=4) for t in tasks]

    with HI():
        out = jax.jit(jax_side)(params, *(batch[k] for k in ("query", "reference", "all_relativeR")))
    return batch, dict(zip(METRICS, out))


@pytest.mark.parametrize("metric", METRICS)
def test_streamed_retrieval_matches_materialised_and_jax(models, jax_streamed, metric):
    _, _, task = _tasks(models, similarity_metric=metric)
    batch, jax_out = jax_streamed
    jsim, jidx = jax_out[metric]
    args = [batch[k] for k in ("query", "reference", "all_relativeR")]
    sim, idx = task.retrieve_streaming(*(_t(a) for a in args), chunk_size=4)
    bank = task.generate_template_bank(_t(batch["reference"]), _t(batch["all_relativeR"]))
    sim_m, idx_m = task.retrieval(_t(batch["query"]), bank)
    # chunking the N axis is exact for every metric (per-template reductions)
    torch.testing.assert_close(sim, sim_m, rtol=1e-5, atol=1e-5)
    assert torch.equal(idx, idx_m)
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    with pytest.raises(ValueError, match="divide"):
        task.stream_similarity(bank[:, 0], bank[:, 0], _t(batch["all_relativeR"]), 3)


@pytest.fixture(scope="module")
def jax_step(models):
    """JAX's eval step on one batch, jitted as evaluate_geodesic jits it
    (the same program as its batches of 3, so the compile cache serves
    both).  JAX's own tests hold its streamed step equal to its
    materialised one."""
    jtask, params, _ = _tasks(models)
    batch = _eval_batch(60, 3)
    step = jax.jit(jtask.eval_geodesic_step, static_argnames=("chunk_size", "refine_steps", "refine_lr"))
    with HI():
        return batch, step(params, batch, chunk_size=4)


@pytest.mark.parametrize("chunk", [None, 4], ids=["materialised", "streamed"])
def test_eval_geodesic_step_matches_jax(models, jax_step, chunk):
    _, _, task = _tasks(models)
    batch, want = jax_step
    got = task.eval_geodesic_step({k: _t(v) for k, v in batch.items()}, chunk_size=chunk)
    assert set(got) == set(want) and len(got) == 11
    np.testing.assert_array_equal(got["nearest_idx"].numpy(), np.asarray(want["nearest_idx"]))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["similarity"].numpy(), np.asarray(want["similarity"]), rtol=1e-4, atol=1e-4)
    for key in set(got) - {"loss", "similarity", "nearest_idx"}:  # degrees
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), atol=1e-4, err_msg=key)
    with pytest.raises(NotImplementedError, match="item 10"):
        task.eval_geodesic_step({k: _t(v) for k, v in batch.items()}, refine_steps=2)


def test_eval_geodesic_step_bf16_runs(models):
    _, _, task = _tasks(models, half_precision_eval=True)
    batch = {k: _t(v) for k, v in _eval_batch(61, 2).items()}
    half = task.half()
    assert next(half.unet.parameters()).dtype == torch.bfloat16
    assert next(task.unet.parameters()).dtype == torch.float32  # the caller's modules stay float32
    for chunk in (None, 4):
        out = task.eval_geodesic_step(batch, chunk_size=chunk, infer_task=half)
        assert out["similarity"].dtype == torch.float32 and out["similarity"].shape == (2, N_GRID)
        assert out["loss"].dtype == torch.float32  # the loss runs on the float32 modules
        assert all(torch.isfinite(torch.as_tensor(v)).all() for v in out.values())
        assert ((out["errors_topk"] >= 0) & (out["errors_topk"] <= 180)).all()


def test_evaluate_geodesic_matches_jax(models, tmp_path):
    """3 batches of 3, 3 and a ragged 2: the same scores, the same dumps,
    and the same retrieval panel from the first batch's ``gt_templates``."""
    from PIL import Image

    jtask, params, task = _tasks(models)
    loader = [_eval_batch(70 + i, b) for i, b in enumerate((3, 3, 2))]
    loader[0]["gt_templates"] = np.random.default_rng(73).uniform(-1, 1, (3, N_GRID, IMG, IMG, 3)).astype(np.float32)
    with HI():
        want = jax_evaluate_geodesic(jtask, params, loader, chunk_size=4, save_dir=str(tmp_path / "jax"))
    got = evaluate_geodesic(task, loader, chunk_size=4, save_dir=str(tmp_path / "port"))
    assert set(got) == set(want) and got["num_images"] == want["num_images"] == 8
    for key in want:
        if key != "images_per_sec":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    assert got["images_per_sec"] > 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == [f"pred_eval_batch{i}_rank0.npz" for i in range(3)] + [
        "retrieved_eval_rank0.png", "retrieved_text_eval_rank0.png"]
    for name in names[:3]:
        with np.load(tmp_path / "port" / name) as a, np.load(tmp_path / "jax" / name) as b:
            assert a.files == b.files
            for key in a.files:
                assert a[key].shape == b[key].shape, (name, key)
    # the same top-1 templates, so the same panel, pixel for pixel
    panel = [np.asarray(Image.open(tmp_path / d / "retrieved_eval_rank0.png")) for d in ("port", "jax")]
    np.testing.assert_array_equal(*panel)
    with pytest.raises(NotImplementedError, match="item 10"):
        evaluate_geodesic(task, loader, refine_steps=1)


def test_evaluate_geodesic_full_means_categories(models):
    from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic_full

    task = _tasks(models)[2]
    task = PoseConditionalTask(task.unet, task.vae, dataclasses.replace(task.config, retrieval_k=3))
    results = evaluate_geodesic_full(task, lambda cat: [_eval_batch(80 + len(cat), 2)], ["a", "bb"])
    assert set(results) == {"a", "bb", "mean"}
    for key, value in results["mean"].items():
        assert value == pytest.approx((results["a"][key] + results["bb"][key]) / 2)
    assert "top5, median" not in results["mean"] and "top3, median" in results["mean"]
