"""The LDM and ADM variants whole, against nope_tpu's on the same
weights and inputs (CPU: the ops run their plain versions): ``build_task``
(the loss, the bank, ``eval_geodesic_step``'s scores and top-k, and the
grad-trace group norms of a train loss) and ``PoseEstimator`` with the
LDM variant.  JAX's side runs as one jitted program a variant; its group
norms are JAX's path rule over the port's gradient carried into JAX's
layout by ``port.port_*``.  Tolerances: ``tests/test_torch_model_zoo.py``'s,
group norms rel 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nope_tpu.configs.config import EncoderConfig, ModelConfig, UNetConfig
from nope_tpu.configs.config import TestingConfig as JaxTestingConfig
from nope_tpu.models.factory import build_task as jax_build_task
from nope_tpu.serving import PoseEstimator as JaxPoseEstimator
from nope_tpu.training import port
from nope_tpu.training.train_state import _group_norms as jax_group_norms
from nope_tpu_torch.models.factory import build_task
from nope_tpu_torch.serving import PoseEstimator
from nope_tpu_torch.training.train_state import _grad_trace_groups, _group_norms
from tests.test_torch_model_zoo import ATOL, HI, RTOL, _gen, _jnp_tree, assert_close, noise_zero_layers
from tests.torch_port_helpers import to_numpy_tree

torch.set_num_threads(1)

TINY_VAE = dict(kind="vae", latent_dim=4, block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_groups=4)
VARIANTS = {
    "vae_cin_ldm": UNetConfig(variant="vae_cin_ldm", model_channels=32, attention_resolutions=(2, 1),
                              num_res_blocks=1, channel_mult=(1, 2), num_head_channels=16, context_dim=24),
    "vae_guidedDiffusion": UNetConfig(variant="vae_guidedDiffusion", model_channels=32,
                                      gd_attention_resolutions=(2,), num_res_blocks=1, gd_channel_mult=(1, 2),
                                      num_head_channels=16),
}
IMG = 32


def variant_config(name, **testing):
    return ModelConfig(u_net=VARIANTS[name], encoder=EncoderConfig(**TINY_VAE), img_size=IMG,
                       testing_config=JaxTestingConfig(half_precision_eval=False, **testing))


def jax_unet_tree(name, named):
    """A U-Net state dict (or gradient) of the port, by parameter name, in
    JAX's layout: ``port.port_ldm_unet`` / ``port.port_adm_unet``."""
    u, sd = VARIANTS[name], to_numpy_tree(named)
    if name == "vae_cin_ldm":
        return port.port_ldm_unet(sd, channel_mult=u.channel_mult, num_res_blocks=u.num_res_blocks,
                                  attention_resolutions=u.attention_resolutions)
    return port.port_adm_unet(sd, channel_mult=u.gd_channel_mult, num_res_blocks=u.num_res_blocks,
                              attention_resolutions=u.gd_attention_resolutions)


@functools.lru_cache(maxsize=None)
def variant_pair(name):
    """(port task, JAX task, JAX params) on the same seeded weights."""
    cfg = variant_config(name)
    task = build_task(cfg, torch.device("cpu"), _gen(40))
    noise_zero_layers(task.unet, 41)
    vae_params = port.port_sd_vae(to_numpy_tree(task.vae.state_dict()), num_blocks=4, layers_per_block=1)
    return task, jax_build_task(cfg), _jnp_tree({"unet": jax_unet_tree(name, task.unet.state_dict()),
                                                 "vae": vae_params})


def eval_batch(seed, b=3, n=8):
    rng = np.random.default_rng(seed)

    def rotations(k):
        q = rng.normal(size=(k, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        w, x, y, z = q.T
        return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                         2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                         2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1).reshape(k, 3, 3)

    grid = rotations(n).astype(np.float32)
    return {
        "query": rng.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32),
        "reference": rng.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32),
        "gt_relativeR": rng.normal(size=(b, 6)).astype(np.float32),
        "all_relativeR": rng.normal(size=(b, n, 6)).astype(np.float32),
        "query_pose": rotations(b).astype(np.float32),
        "template_poses": np.ascontiguousarray(np.broadcast_to(grid, (b, n, 3, 3))),
        "symmetry": np.arange(b) % 3,
    }


def decided_rows(sim, margin=1e-3):
    top2 = np.sort(sim, axis=1)[:, ::-1][:, :2]
    return (top2[:, 0] - top2[:, 1]) > margin * np.abs(sim).max()


def jax_variant_outputs(jtask, params, batch):
    """JAX's bank and eval step in one jitted program (one compile instead
    of op-by-op dispatch): (loss, bank, similarity, nearest_idx), the loss
    the eval step's, which is ``forward_loss`` at the true pose."""

    def run(params, batch):
        bank = jtask.generate_template_bank(params, batch["reference"], batch["all_relativeR"])
        out = jtask.eval_geodesic_step(params, batch)
        return out["loss"], bank, out["similarity"], out["nearest_idx"]

    with HI():
        return jax.device_get(jax.jit(run)(params, {k: jnp.asarray(v) for k, v in batch.items()}))


def group_norms_both_ways(task, train, jax_tree):
    """The grad-trace group norms of one train loss's U-Net gradient: the
    port's module-type groups, and JAX's path rule (``_group_norms`` of
    ``nope_tpu.training.train_state``) over the same gradient in JAX's
    layout (``jax_tree``: named gradient -> JAX tree)."""
    task.unet.zero_grad(set_to_none=True)
    task.train_loss({k: torch.from_numpy(v) for k, v in train.items()}).backward()
    grads = {n: p.grad for n, p in task.unet.named_parameters()}
    got = _group_norms(grads, _grad_trace_groups(task.unet), "gnorm")
    want = jax_group_norms(_jnp_tree(jax_tree(grads)), "gnorm")
    task.unet.zero_grad(set_to_none=True)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-5, err_msg=k)
    return want


def train_batch(batch):
    return {"query": batch["query"], "reference": batch["reference"], "relativeR": batch["gt_relativeR"],
            "relativeR_inv": batch["all_relativeR"][:, 0]}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_task_matches_jax(name):
    """``build_task`` of the variant against JAX's on the same weights:
    the loss, the bank, the eval step's scores and top-k, and the group
    norms of one train loss's U-Net gradient: the port's module-type
    grad-trace groups against JAX's path rule (``pose_mlp`` takes
    ``pose_mlp_timesteps`` too, ``*_attn_*`` the transformers and ADM
    attention whole, ``emb_dense`` the conv trunk)."""
    task, jtask, params = variant_pair(name)
    batch = eval_batch(50)
    j_loss, j_bank, j_sim, j_idx = jax_variant_outputs(jtask, params, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss = float(task.forward_loss(tb["query"], tb["reference"], tb["gt_relativeR"]))
        bank = task.generate_template_bank(tb["reference"], tb["all_relativeR"]).numpy()
    out = task.eval_geodesic_step(tb)
    np.testing.assert_allclose(loss, float(j_loss), rtol=RTOL, atol=ATOL)
    assert bank.shape == j_bank.shape == (3, 8, 4, 4, 4)
    assert_close(bank, np.asarray(j_bank))
    j_sim = np.asarray(j_sim)
    assert_close(out["similarity"].numpy(), j_sim)
    rows = decided_rows(j_sim)
    assert rows.sum() >= 2
    np.testing.assert_array_equal(out["nearest_idx"].numpy()[rows, 0], np.asarray(j_idx)[rows, 0])

    j_norms = group_norms_both_ways(task, train_batch(batch), functools.partial(jax_unet_tree, name))
    assert all(float(j_norms[f"gnorm/{g}"]) > 0 for g in ("pose_mlp", "attn", "conv"))
    # the ResBlocks' embedding layers are trunk, as JAX's emb_dense
    assert {g for n, g in _grad_trace_groups(task.unet).items() if "emb_layers" in n} == {"conv"}


def test_ldm_estimator_matches_jax():
    """``PoseEstimator`` with the LDM variant against ``nope_tpu.serving``:
    scores and top-k on the N=26 grid (float32)."""
    task, jtask, params = variant_pair("vae_cin_ldm")
    rng = np.random.default_rng(52)
    ref, queries = rng.uniform(-1, 1, (IMG, IMG, 3)).astype(np.float32), rng.uniform(-1, 1, (3, IMG, IMG, 3))
    queries = queries.astype(np.float32)
    with HI():
        jest = JaxPoseEstimator(jtask, params, fast_evaluation=True)
        jest.register_object("obj", ref)
        want = jest.estimate("obj", queries)
    est = PoseEstimator(task, fast_evaluation=True)
    est.register_object("obj", ref)
    got = est.estimate("obj", queries)
    assert got.similarity.shape == (3, 26)
    assert_close(got.similarity, want.similarity)
    rows = decided_rows(want.similarity)
    assert rows.sum() >= 2
    np.testing.assert_array_equal(got.nearest_idx[rows, 0], want.nearest_idx[rows, 0])
    np.testing.assert_allclose(got.relative_rotations[rows, 0], want.relative_rotations[rows, 0], atol=1e-6)
