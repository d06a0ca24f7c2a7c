"""The port learns: the JAX package's learning tests
(``tests/test_learning.py``, ``tests/test_end_to_end.py::
test_overfit_single_batch``) run on ``nope_tpu_torch`` at their tiny
sizes on the CPU, held to the JAX tests' own bounds rather than to JAX's
trajectory (past ~10 steps two float programs drift apart as far as one
program from a start nudged by 1e-7).

- 120 train steps on a procedural ShapeNet root (images rendered from
  their poses, so retrieval is learnable) cut the eval loss below 0.7x
  and improve the top-1 median error; on the trained model bf16 and fp32
  retrieval agree within one item;
- VAE pretraining cuts the reconstruction loss below 0.6x in 60 steps,
  and its bf16 step keeps float32 master weights;
- 30 steps on one repeated batch cut the loss below 0.6x.

The starting weights are the JAX tests' own: JAX's seeded initialisers,
carried over through ``nope_tpu_torch.weights``.  K3 and K2 run their
plain versions here (CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu_torch.configs import load_config
from nope_tpu_torch.data.shapenet import ShapeNetDataset
from nope_tpu_torch.geometry import rotations
from nope_tpu_torch.models.factory import build_task
from nope_tpu_torch.models.unet import PoseUNet
from nope_tpu_torch.models.vae import StableDiffusionVAE
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig
from nope_tpu_torch.training import optim, train_state
from nope_tpu_torch.training.pretrain_vae import create_vae_pretrain_state, make_vae_pretrain_step
from nope_tpu_torch.weights import unet_state_dict_from_jax, vae_state_dict_from_jax
from tests.fixtures import make_procedural_shapenet

torch.set_num_threads(1)

IMG, STEPS = 32, 120
UNET = dict(u_net_dim=16, channels=4, dim_mults=(1, 2), resnet_block_groups=8)
VAE = dict(block_out_channels=(16, 16, 16, 16), layers_per_block=1, latent_channels=4, groups=8)


@pytest.fixture(scope="module")
def procedural_root(tmp_path_factory):
    return make_procedural_shapenet(str(tmp_path_factory.mktemp("procedural")), objects_per_cat=2)


def _jax_init_unet(seed):
    params = JaxPoseUNet(**UNET).init(jax.random.key(seed), jnp.zeros((1, IMG // 8, IMG // 8, 4)),
                                      jnp.zeros((1, 6)))["params"]
    unet = PoseUNet(**UNET)
    unet.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    return unet


def _jax_init_vae(seed):
    params = JaxVAE(**VAE).init(jax.random.key(seed), jnp.zeros((1, IMG, IMG, 3)))["params"]
    vae = StableDiffusionVAE(**VAE)
    vae.load_state_dict(vae_state_dict_from_jax(params), strict=True)
    return vae


def _invert_6d(d6):
    """6d of the transposed rotation (ΔR⁻¹), as ``tests/test_learning.py``."""
    m = rotations.rotation_6d_to_matrix(torch.from_numpy(np.asarray(d6, np.float32)))
    return rotations.matrix_to_rotation_6d(m.transpose(-1, -2)).numpy()


def test_training_improves_retrieval(procedural_root):
    ds = ShapeNetDataset(procedural_root, split="bottle", img_size=IMG, fast_evaluation=True)
    items = [ds[i] for i in range(len(ds))]
    eval_batch = {k: torch.from_numpy(np.stack([it[k] for it in items])) for k in items[0]}

    task = PoseConditionalTask(_jax_init_unet(0), _jax_init_vae(1), TaskConfig(half_precision_eval=False))
    task.vae.requires_grad_(False)
    state = train_state.create_train_state(task, optim.make_optimizer(task.unet.parameters(), base_lr=2e-3,
                                                                      warm_up_steps=10))
    step_fn = train_state.make_train_step(task)

    def eval_errors(t):
        out = t.eval_geodesic_step(eval_batch)
        return out["errors_topk"].numpy(), float(out["loss"]), out["nearest_idx"].numpy()

    errors_before, loss_before, _ = eval_errors(task)
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        sel = rng.integers(0, len(items), 4)
        batch = {"ds": {
            "query": np.stack([items[i]["query"] for i in sel]),
            "reference": np.stack([items[i]["reference"] for i in sel]),
            "relativeR": np.stack([items[i]["gt_relativeR"] for i in sel]),
            "relativeR_inv": np.stack([_invert_6d(items[i]["gt_relativeR"]) for i in sel]),
        }}
        state, _ = step_fn(state, batch)
    assert state.step == STEPS
    errors_after, loss_after, idx_fp32 = eval_errors(task)

    top1_before, top1_after = np.median(errors_before[:, 0]), np.median(errors_after[:, 0])
    med_before = np.median(np.min(errors_before[:, :5], axis=1))
    med_after = np.median(np.min(errors_after[:, :5], axis=1))
    print(f"loss {loss_before:.4f}->{loss_after:.4f}, top1 median err {top1_before:.1f}->{top1_after:.1f} deg, "
          f"top5 {med_before:.1f}->{med_after:.1f} deg")
    assert loss_after < 0.7 * loss_before
    assert top1_after < top1_before
    # the top-5 saturates at the grid floor (~5.45 deg) on the smooth
    # renders, where templates equally far from the query score errors
    # that differ by float32 noise (~3e-5 deg): no worse than that floor
    assert med_after <= med_before + 1e-3

    # the bf16 guardrail: on the trained model, half-precision retrieval
    # matches fp32 within one item of the protocol
    bf16 = PoseConditionalTask(task.unet, task.vae, dataclasses.replace(task.config, half_precision_eval=True))
    out_bf16 = bf16.eval_geodesic_step(eval_batch)
    idx_bf16 = out_bf16["nearest_idx"].numpy()
    n = len(idx_fp32)
    top1_agree = float(np.mean(idx_fp32[:, 0] == idx_bf16[:, 0]))
    acc15 = [float(np.mean(e[:, 0] <= 15.0)) for e in (errors_after, out_bf16["errors_topk"].numpy())]
    print(f"bf16 guardrail: top1 agreement {top1_agree:.2f}, Acc@15 {acc15[0]:.2f} vs {acc15[1]:.2f}")
    assert top1_agree >= 1.0 - 1.0 / n - 1e-9
    assert abs(acc15[0] - acc15[1]) <= 1.0 / n + 1e-9


def test_vae_pretraining_improves_reconstruction(procedural_root):
    ds = ShapeNetDataset(procedural_root, split="bottle", img_size=IMG)
    images = torch.from_numpy(np.stack([ds[i]["query"] for i in range(4)]))

    state = create_vae_pretrain_state(_jax_init_vae(0), lr=1e-3)
    step = make_vae_pretrain_step()
    state, first = step(state, images)
    for _ in range(60):
        state, metrics = step(state, images)
    print(f"vae pretrain recon {float(first['recon']):.4f}->{float(metrics['recon']):.4f}, "
          f"kl {float(metrics['kl']):.1f}")
    assert float(metrics["recon"]) < 0.6 * float(first["recon"])
    assert np.isfinite(float(metrics["kl"]))

    # the bf16 step keeps float32 master weights, and its loss is finite
    hp_state = create_vae_pretrain_state(_jax_init_vae(1), lr=1e-3)
    hp_state, hp_metrics = make_vae_pretrain_step(half_precision=True)(hp_state, images)
    assert all(p.dtype == torch.float32 for p in hp_state.vae.parameters())
    assert np.isfinite(float(hp_metrics["loss"]))


def test_overfit_single_batch():
    """30 steps on one repeated batch must cut the loss below 0.6x (broken
    gradients, optimizer or schedule would not), on the tiny config of
    ``tests/test_end_to_end.py``."""
    cfg = load_config(None, ["model.img_size=32", "model.u_net.u_net_dim=8", "model.u_net.dim_mults=1,2",
                             "model.u_net.resnet_block_groups=4", "model.encoder.block_out_channels=8,8,8,8",
                             "model.encoder.layers_per_block=1", "model.encoder.norm_groups=4"])
    task = build_task(cfg.model, torch.device("cpu"), torch.Generator().manual_seed(0))
    state = train_state.create_train_state(task, optim.make_optimizer(task.unet.parameters(), base_lr=3e-3,
                                                                      warm_up_steps=5))
    step_fn = train_state.make_train_step(task)
    rng = np.random.default_rng(0)
    mats = rotations.random_rotations(2, torch.Generator().manual_seed(1))
    batch = {"ds": {
        "query": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
        "reference": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
        "relativeR": rotations.matrix_to_rotation_6d(mats).numpy(),
        "relativeR_inv": rotations.matrix_to_rotation_6d(mats.transpose(-1, -2)).numpy(),
    }}
    losses = []
    for _ in range(30):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss/train_avg"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.6 * losses[0], (losses[0], losses[-1])
