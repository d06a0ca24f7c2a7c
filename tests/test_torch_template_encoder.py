"""The template encoders of the port against nope_tpu's (CPU): the ResNet
backbones with frozen BatchNorm, ``TemplateFeatureExtractor`` (ResNet-50)
and ``BaseFeatureExtractor`` with their weight converters both ways,
``info_nce_loss`` and ``occlusion_aware_similarity``, the
``template_base`` variant whole through ``build_task`` (descriptors of
C = 8 reach K1's plain version in retrieval), the serving gap both
packages share, checkpoints of the encoder's keys and the bf16 copy of a
module with buffers.  Tolerances: ``tests/test_torch_model_zoo.py``'s;
the losses rel 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nope_tpu.configs.config import EncoderConfig, ModelConfig, UNetConfig
from nope_tpu.configs.config import TestingConfig as JaxTestingConfig
from nope_tpu.models import resnet as jresnet
from nope_tpu.models import template_encoder as jtemplate
from nope_tpu.models.factory import build_task as jax_build_task
from nope_tpu.serving import PoseEstimator as JaxPoseEstimator
from nope_tpu.training import port
from nope_tpu_torch import weights
from nope_tpu_torch.models import resnet, template_encoder
from nope_tpu_torch.models.factory import build_task
from nope_tpu_torch.serving import PoseEstimator
from nope_tpu_torch.tasks.pose_conditional import cast_half
from nope_tpu_torch.training import checkpoint
from nope_tpu_torch.training.train_state import _HalfCopy
from tests.test_torch_model_zoo import HI, _gen, _jnp_tree, assert_close, nchw_to_jax, seeded
from tests.test_torch_model_zoo_variants import (
    decided_rows,
    eval_batch,
    group_norms_both_ways,
    jax_variant_outputs,
    train_batch,
)
from tests.torch_port_helpers import assert_trees_equal, to_numpy_tree

torch.set_num_threads(1)
IMG = 32


@torch.no_grad()
def randomize_statistics(module, seed):
    """BatchNorm statistics and affine away from their (0, 1) init."""
    gen = _gen(seed)
    for m in module.modules():
        if isinstance(m, resnet.FrozenBatchNorm):
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.normal_(0.0, 0.1, generator=gen)
    return module


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, IMG, IMG, 3)).astype(np.float32)


@pytest.mark.parametrize("block,layers,fc", [("bottleneck", (1, 2, 1, 1), False), ("basic", (2, 1, 1, 1), True)])
def test_resnet_matches_jax(block, layers, fc):
    """A narrow ResNet (features 8) of either block, strides (1, 2, 2, 1),
    against JAX's; with ``use_avg_pooling_and_fc`` the stem max-pool and
    the head too."""
    klass = {"bottleneck": (resnet.Bottleneck, jresnet.Bottleneck), "basic": (resnet.BasicBlock, jresnet.BasicBlock)}
    kw = dict(layers=layers, features=8, use_avg_pooling_and_fc=fc, num_classes=10)
    mod = randomize_statistics(seeded(resnet.ResNet(block=klass[block][0], **kw), 60), 61)
    sd = {f"backbone.{k}": v for k, v in to_numpy_tree(mod.state_dict()).items()}
    params = port.port_template_encoder({**sd, "projector.1.weight": np.zeros((1, 1, 1, 1), np.float32),
                                         "projector.3.weight": np.zeros((1, 1, 1, 1), np.float32)},
                                        layers=layers)["backbone"]
    if fc:
        params["fc"] = port._linear(sd, "backbone.fc")
    x = _images(62).transpose(0, 3, 1, 2).copy()
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    with HI():
        want = jax.jit(jresnet.ResNet(block=klass[block][1], **kw).apply)(
            {"params": _jnp_tree(params)}, nchw_to_jax(x))
    want = np.asarray(want)
    assert_close(got, want if fc else np.transpose(want, (0, 3, 1, 2)))


def test_resnet_presets():
    for name, blocks in (("resnet18", 8), ("resnet34", 16), ("resnet50", 16), ("resnet101", 33), ("resnet152", 50)):
        with torch.device("meta"):
            mod = getattr(resnet, name)()
        assert sum(len(getattr(mod, f"layer{i}")) for i in range(1, 5)) == blocks
        assert mod.out_channels == (512 if name in ("resnet18", "resnet34") else 2048)


@pytest.fixture(scope="module")
def extractor():
    return randomize_statistics(seeded(template_encoder.TemplateFeatureExtractor(descriptor_size=8), 63), 64)


def test_template_extractor_matches_jax_and_round_trips(extractor):
    """ResNet-50 → projector at 32 px: f8 features (4, 4, 8), against JAX's
    on the weights through ``port_template_encoder``, and back bitwise."""
    sd = to_numpy_tree(extractor.state_dict())
    params = port.port_template_encoder(sd)
    assert_trees_equal(to_numpy_tree(weights.template_encoder_state_dict_from_jax(params)), sd)
    x = _images(65)
    with torch.no_grad():
        got = extractor.encode_image(torch.from_numpy(x)).numpy()
    with HI():
        jmod = jtemplate.TemplateFeatureExtractor(descriptor_size=8)
        want = np.asarray(jax.jit(jmod.apply)({"params": _jnp_tree(params)}, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 4, 4, 8)
    assert_close(got, want)


def test_template_extractor_loads_torchvision_batchnorm_strict(extractor):
    """A reference state dict (torchvision ``BatchNorm2d``: with
    ``num_batches_tracked``) loads with strict=True."""
    sd = dict(extractor.state_dict())
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    fresh = template_encoder.TemplateFeatureExtractor(descriptor_size=8)
    fresh.load_state_dict(sd, strict=True)
    assert "backbone.layer4.2.bn3.running_mean" in fresh.state_dict()
    assert "backbone.bn1.num_batches_tracked" not in fresh.state_dict()


def test_normalized_extractor_has_unit_descriptors(extractor):
    mod = template_encoder.TemplateFeatureExtractor(descriptor_size=8, normalize=True)
    mod.load_state_dict(extractor.state_dict())
    with torch.no_grad():
        feat = mod.encode_image(torch.from_numpy(_images(66)))
    np.testing.assert_allclose(torch.linalg.norm(feat, dim=-1).numpy(), 1.0, rtol=1e-5)


def test_base_feature_extractor_matches_jax_and_round_trips():
    mod = seeded(template_encoder.BaseFeatureExtractor(descriptor_size=8), 67)
    sd = to_numpy_tree(mod.state_dict())
    params = port.port_base_feature_extractor(sd)
    assert_trees_equal(to_numpy_tree(weights.base_feature_extractor_state_dict_from_jax(params)), sd)
    x = _images(68)
    with torch.no_grad():
        got = mod.encode_image(torch.from_numpy(x)).numpy()
    with HI():
        want = np.asarray(jtemplate.BaseFeatureExtractor(descriptor_size=8).apply({"params": _jnp_tree(params)},
                                                                                 jnp.asarray(x)))
    assert got.shape == want.shape == (2, 9, 9, 8)  # unpadded convs: an odd side
    assert_close(got, want)


@pytest.mark.parametrize("extra", [None, "BOP_ShapeNet", "ShapeNet_ShapeNet"])
def test_info_nce_loss_matches_jax(extra):
    rng = np.random.default_rng(69)
    pos, neg, more = (rng.normal(size=(6, 6)).astype(np.float32) for _ in range(3))
    kw = {} if extra is None else {"extra_contrast_type": extra}
    got = template_encoder.info_nce_loss(torch.from_numpy(pos), torch.from_numpy(neg), 0.1,
                                         None if extra is None else torch.from_numpy(more), **kw)
    want = jtemplate.info_nce_loss(jnp.asarray(pos), jnp.asarray(neg), 0.1,
                                   None if extra is None else jnp.asarray(more), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    with pytest.raises(ValueError, match="extra_contrast_type"):
        template_encoder.info_nce_loss(torch.from_numpy(pos), torch.from_numpy(neg),
                                       sim_extra_obj=torch.from_numpy(more), extra_contrast_type="other")


def test_occlusion_aware_similarity_matches_jax():
    sim = np.random.default_rng(70).uniform(-0.5, 1.0, (3, 40)).astype(np.float32)
    sim[0, :3] = 0.2  # at the threshold: zeroed
    got = template_encoder.occlusion_aware_similarity(torch.from_numpy(sim), 0.2).numpy()
    want = np.asarray(jtemplate.occlusion_aware_similarity(jnp.asarray(sim), 0.2))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got[0, :3] == 0).all()


# -- the template_base variant -------------------------------------------------------

def template_config(half=False):
    return ModelConfig(
        u_net=UNetConfig(variant="template_base", u_net_dim=8, dim_mults=(1, 2), resnet_block_groups=4),
        encoder=EncoderConfig(kind="template", latent_dim=8, descriptor_size=8), img_size=IMG,
        testing_config=JaxTestingConfig(half_precision_eval=half))


@pytest.fixture(scope="module")
def template_pair():
    cfg = template_config()
    task = build_task(cfg, torch.device("cpu"), _gen(71))
    randomize_statistics(task.vae, 72)
    params = {"unet": port.port_pose_unet(to_numpy_tree(task.unet.state_dict()), dim_mults=(1, 2)),
              "vae": port.port_template_encoder(to_numpy_tree(task.vae.state_dict()))}
    return task, jax_build_task(cfg), _jnp_tree(params)


def test_template_variant_task_matches_jax(template_pair):
    """``build_task`` with the ResNet-50 template encoder (descriptor 8)
    against JAX's: loss, bank (C = 8), eval step scores and top-k, and the
    grad-trace group norms (JAX's path rule over the port's gradient); no
    RGB preview without a decoder."""
    task, jtask, params = template_pair
    batch = eval_batch(73)
    j_loss, j_bank, j_sim, j_idx = jax_variant_outputs(jtask, params, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss = float(task.forward_loss(tb["query"], tb["reference"], tb["gt_relativeR"]))
        bank = task.generate_template_bank(tb["reference"], tb["all_relativeR"]).numpy()
        pred, rgb = task.sample(tb["reference"], tb["gt_relativeR"], decode_rgb=True)
    out = task.eval_geodesic_step(tb)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-3, atol=5e-4)
    assert bank.shape == np.shape(j_bank) == (3, 8, 4, 4, 8)
    assert_close(bank, np.asarray(j_bank))
    j_sim = np.asarray(j_sim)
    assert_close(out["similarity"].numpy(), j_sim)
    rows = decided_rows(j_sim)
    assert rows.sum() >= 2
    np.testing.assert_array_equal(out["nearest_idx"].numpy()[rows, 0], np.asarray(j_idx)[rows, 0])
    assert rgb is None and pred.shape == (3, 4, 4, 8)
    with pytest.raises(NotImplementedError, match="no decoder"):
        task.decode(pred)
    group_norms_both_ways(task, train_batch(batch),
                          lambda grads: port.port_pose_unet(to_numpy_tree(grads), dim_mults=(1, 2)))


def test_template_variant_serving_gap_is_shared(template_pair):
    """Both packages' estimators pin the latent geometry from the VAE's
    ``block_out_channels``, so neither serves a template encoder: both
    raise the same AttributeError at registration."""
    task, jtask, params = template_pair
    ref = _images(74, 1)[0]
    with pytest.raises(AttributeError, match="block_out_channels"):
        JaxPoseEstimator(jtask, params, fast_evaluation=True).register_object("obj", ref)
    with pytest.raises(AttributeError, match="block_out_channels"):
        PoseEstimator(task, fast_evaluation=True).register_object("obj", ref)


def test_template_checkpoint_round_trip_and_reference_layout(template_pair, tmp_path):
    """The port's checkpoint of a template task restores strictly; a
    reference-layout file, its encoder under ``u_net.encoder.`` alone
    (``backbone.*``, ``projector.*``), splits into the same two dicts."""
    task, _, _ = template_pair
    path = os.path.join(tmp_path, "template.pth")
    checkpoint.save_reference_checkpoint(path, task.unet.state_dict(), task.vae.state_dict())
    fresh = build_task(template_config(), torch.device("cpu"), _gen(75))
    checkpoint.restore_params(path, fresh)
    for a, b in zip(fresh.vae.state_dict().values(), task.vae.state_dict().values()):
        assert torch.equal(a, b)
    reference = {**{f"u_net.{k}": v for k, v in task.unet.state_dict().items()},
                 **{f"u_net.encoder.{k}": v for k, v in task.vae.state_dict().items()}}
    unet, encoder = checkpoint.split_state_dict(reference)
    assert set(unet) == set(task.unet.state_dict()) and set(encoder) == set(task.vae.state_dict())
    ref_path = os.path.join(tmp_path, "reference.pth")
    torch.save({"state_dict": reference}, ref_path)
    assert checkpoint.restore_eval_params(ref_path, build_task(template_config(), torch.device("cpu"), _gen(76)))


def test_half_copy_of_a_module_with_buffers(extractor):
    """``cast_half`` casts the BatchNorm statistics with the weights, and
    the train step's cached bf16 copy is made again when only a buffer
    changes in place (a restore of the encoder)."""
    half = cast_half(extractor)
    assert half.backbone.bn1.running_var.dtype == torch.bfloat16
    assert extractor.backbone.bn1.running_var.dtype == torch.float32
    copies = _HalfCopy()
    first = copies(extractor)
    assert copies(extractor) is first
    with torch.no_grad():
        extractor.backbone.bn1.running_mean.add_(0.0)
    assert copies(extractor) is not first
