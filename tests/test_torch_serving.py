"""The slice as a whole: the port's PoseEstimator (register_object +
estimate) against nope_tpu's on the same weights, the bf16 path, the
factory, and a subprocess proof that the port imports no JAX."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from nope_tpu.configs.config import ModelConfig
from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.serving import PoseEstimator as JaxPoseEstimator
from nope_tpu.tasks.pose_conditional import PoseConditionalTask as JaxTask
from nope_tpu.tasks.pose_conditional import TaskConfig as JaxTaskConfig
from nope_tpu_torch.models.factory import build_task
from nope_tpu_torch.serving import PoseEstimator
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig
from tests.torch_port_helpers import IMG, UNET, VAE, torch_unet, torch_vae

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_side():
    task = JaxTask(JaxPoseUNet(**UNET), JaxVAE(**VAE), JaxTaskConfig(half_precision_eval=False))
    params = task.init(jax.random.key(5), image_size=IMG)
    return task, params


def _port_task(params, half):
    return PoseConditionalTask(
        torch_unet(params["unet"]), torch_vae(params["vae"]),
        TaskConfig(half_precision_eval=half),
    )


def _images(seed, n):
    return np.random.default_rng(seed).uniform(-1, 1, (n, IMG, IMG, 3)).astype(np.float32)


def test_fp32_estimator_matches_jax(jax_side):
    task, params = jax_side
    ref, queries = _images(10, 1)[0], _images(11, 3)
    with jax.default_matmul_precision("highest"):
        jest = JaxPoseEstimator(task, params, fast_evaluation=True)
        jest.register_object("obj", ref)
        want = jest.estimate("obj", queries)
    est = PoseEstimator(_port_task(params, half=False), fast_evaluation=True)
    est.register_object("obj", ref)
    got = est.estimate("obj", queries)

    assert got.similarity.shape == (3, 26) and got.similarity.dtype == np.float32
    # banks agree to the U-Net's 2e-4 tolerance; each score sums 16 pixels
    np.testing.assert_allclose(got.similarity, want.similarity, rtol=1e-4, atol=1e-4)
    gaps = -np.diff(np.sort(want.similarity, axis=1)[:, ::-1][:, :6], axis=1)
    assert gaps.min() > 1e-3  # no near-ties among the top-k: the order is defined
    np.testing.assert_array_equal(got.nearest_idx, want.nearest_idx)
    np.testing.assert_allclose(got.relative_rotations, want.relative_rotations, atol=1e-6)
    np.testing.assert_array_equal(got.template_poses, want.template_poses)


def test_bf16_estimator_top1_on_planted_match(jax_side):
    _, params = jax_side
    est = PoseEstimator(_port_task(params, half=True), fast_evaluation=True)
    assert est.dtype == torch.bfloat16
    est.register_object("obj", _images(10, 1)[0])
    bank = est._banks["obj"]
    assert bank.shape == (1, 26, IMG // 8, IMG // 8, 4) and bank.dtype == torch.bfloat16
    planted = [3, 11, 25]
    _, idx = est.task.retrieval(None, bank, query_latent=bank[0, planted])
    np.testing.assert_array_equal(idx[:, 0].numpy(), planted)
    result = est.estimate("obj", _images(12, 2))
    assert result.nearest_idx.shape == (2, 5) and np.isfinite(result.similarity).all()


def test_unported_paths_raise(jax_side):
    _, params = jax_side
    task = _port_task(params, half=False)
    with pytest.raises(ValueError, match="bank_dtype"):
        PoseEstimator(task, fast_evaluation=True, bank_dtype="int4")
    est = PoseEstimator(task, fast_evaluation=True)
    est.register_object("obj", _images(10, 1)[0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        est.estimate("obj", _images(11, 1), refine_steps=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        est.estimate_many(["obj"], _images(11, 1), refine_steps=2)
    est.deregister_object("obj")
    with pytest.raises(KeyError, match="not registered"):
        est.estimate("obj", _images(11, 1))


def test_factory_builds_seeded_float32_task():
    cfg = ModelConfig()
    cfg.u_net.u_net_dim, cfg.u_net.dim_mults = 16, (1, 2)
    cfg.encoder.block_out_channels, cfg.encoder.layers_per_block, cfg.encoder.norm_groups = (8, 8, 8, 8), 1, 4
    a = build_task(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    b = build_task(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    assert a.device.type == "cpu" and next(a.unet.parameters()).dtype == torch.float32
    assert a.config.half_precision_eval and a.config.retrieval_k == 5
    for (k, v), w in zip(a.unet.state_dict().items(), b.unet.state_dict().values()):
        assert torch.equal(v, w), k
    lat = a.encode(torch.zeros(1, IMG, IMG, 3))
    assert lat.shape == (1, IMG // 8, IMG // 8, 4)


def test_port_imports_no_jax_in_a_fresh_process():
    code = textwrap.dedent(
        """
        import sys, types
        import numpy as np, torch
        import nope_tpu_torch
        from nope_tpu_torch import weights
        from nope_tpu_torch.evaluation import geodesic
        from nope_tpu_torch.geometry import rotations, so3_grid, transforms
        from nope_tpu_torch.models import blocks, distributions, factory, unet, vae
        from nope_tpu_torch.ops import _build, fused_resnet, linear_attention, similarity
        from nope_tpu_torch.serving import PoseEstimator, engine
        from nope_tpu_torch.tasks import metrics, pose_conditional
        from nope_tpu_torch.utils import visualization
        ns = types.SimpleNamespace
        cfg = ns(
            u_net=ns(variant="vae_base", u_net_dim=16, dim_mults=(1, 2), rot_representation_dim=6,
                     pose_mlp_name="single_layer", resnet_block_groups=8, double_bottleneck=True),
            encoder=ns(kind="vae", latent_dim=4, block_out_channels=(8, 8, 8, 8),
                       layers_per_block=1, norm_groups=4, using_KL=False),
            optim_config=ns(loss_type="l1", use_inv_deltaR=True),
            testing_config=ns(similarity_metric="l2", retrieval_k=5, half_precision_eval=False),
        )
        torch.set_num_threads(1)
        task = factory.build_task(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
        est = PoseEstimator(task, fast_evaluation=True)
        rng = np.random.default_rng(0)
        est.register_object("o", rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32))
        r = est.estimate("o", rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
        assert r.nearest_idx.shape == (2, 5) and np.isfinite(r.similarity).all()
        grid = est.template_poses
        rel = transforms.relative_rotation(torch.from_numpy(grid)[None].expand(2, -1, -1, -1),
                                           torch.from_numpy(grid[:1])[None].expand(2, len(grid), -1, -1))
        batch = dict(query=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                     reference=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                     gt_relativeR=rotations.matrix_to_rotation_6d(rel[:, 3]).numpy(),
                     all_relativeR=rotations.matrix_to_rotation_6d(rel).numpy(),
                     query_pose=grid[[3, 7]], template_poses=np.broadcast_to(grid, (2,) + grid.shape),
                     symmetry=np.array([0, 2]))
        scores = geodesic.evaluate_geodesic(task, [batch], chunk_size=13)
        assert scores["num_images"] == 2 and np.isfinite(scores["top1, median"])
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "nope_tpu"))
        assert not bad, bad
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_chunked_bank_equals_one_pass(jax_side):
    _, params = jax_side
    task = _port_task(params, half=False)
    rng = np.random.default_rng(6)
    ref_lat = torch.from_numpy(rng.normal(size=(2, IMG // 8, IMG // 8, 4)).astype(np.float32))
    poses = torch.from_numpy(rng.normal(size=(2, 6, 6)).astype(np.float32))
    whole = task.generate_template_bank(None, poses, reference_latent=ref_lat)
    chunked = task.generate_template_bank(None, poses, chunk_size=3, reference_latent=ref_lat)
    assert whole.shape == (2, 6, IMG // 8, IMG // 8, 4)
    # the same per-sample math in other batch groupings
    torch.testing.assert_close(chunked, whole, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        task.generate_template_bank(None, poses, chunk_size=4, reference_latent=ref_lat)
