"""The port's PoseUNet and VAE encoder against nope_tpu's on the same
weights and inputs (CPU: the ops run their plain versions)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.ops.experimental import linear_attention as jla
from nope_tpu_torch.models import blocks
from tests.torch_port_helpers import (
    IMG,
    LATENT_HW,
    UNET,
    VAE,
    jax_unet_params,
    jax_vae_params,
    torch_unet,
    torch_vae,
)


@pytest.mark.parametrize("fused", [False, True])
def test_pose_unet_matches_jax(fused, monkeypatch):
    if fused:
        # the JAX linear-attention kernel runs on the CPU only in
        # interpret mode, as tests/test_linear_attention.py runs it
        monkeypatch.setattr(
            jla, "linear_attention_inner", functools.partial(jla.linear_attention_inner, interpret=True)
        )
    params = jax_unet_params()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, LATENT_HW, LATENT_HW, 4)).astype(np.float32)
    pose = rng.normal(size=(2, 6)).astype(np.float32)
    jmodel = JaxPoseUNet(**UNET, fused_attention=fused, fused_resnet=fused)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(pose)))
    with torch.no_grad():
        got = torch_unet(params)(
            torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(pose)
        ).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, LATENT_HW, LATENT_HW, 4)
    # the repo's U-Net parity tolerance (tests/test_unet_parity.py)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_single_bottleneck_changes_the_output():
    params = jax_unet_params()
    model = torch_unet(params)
    x, pose = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(0)), torch.zeros(1, 6)
    with torch.no_grad():
        a = model(x, pose)
        model.double_bottleneck = False
        b = model(x, pose)
    assert not torch.allclose(a, b)


def test_vae_encode_image_matches_jax():
    params = jax_vae_params()
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, size=(2, IMG, IMG, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxVAE(**VAE).apply(
            {"params": params}, jnp.asarray(img), "mode", method=JaxVAE.encode_image))
    with torch.no_grad():
        got = torch_vae(params).encode_image(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, IMG // 8, IMG // 8, 4)
    # the repo's VAE parity tolerance (tests/test_vae_parity.py)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_hard_downsample_channel_order():
    """Output channel c*4 + p1*2 + p2 (the reference rearrange)."""
    x = torch.arange(2 * 4 * 4, dtype=torch.float32).reshape(1, 2, 4, 4)
    down = blocks.HardDownsample(2, 8)
    unshuffled = down[0](x)
    assert torch.equal(unshuffled[0, 1 * 4 + 1 * 2 + 0, 0, 0], x[0, 1, 1, 0])
    assert torch.equal(unshuffled[0, 0 * 4 + 0 * 2 + 1, 1, 1], x[0, 0, 2, 3])


@pytest.mark.parametrize("kind", ["single_layer", "two_layers", "posEncoding"])
def test_pose_mlp_matches_jax(kind):
    from nope_tpu.models.blocks import PoseMLP as JaxPoseMLP

    rng = np.random.default_rng(5)
    pose = rng.normal(size=(3, 6)).astype(np.float32)
    jmlp = JaxPoseMLP(out_dim=48, kind=kind)
    params = jmlp.init(jax.random.key(0), jnp.zeros((1, 6)))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmlp.apply(params, jnp.asarray(pose)))
    mlp = blocks.PoseMLP(6, 48, kind=kind)
    sd = {}
    for name, idx in (("fc0", "0"), ("fc1", "2")):
        if name in params.get("params", {}):
            p = params["params"][name]
            sd[f"{idx}.weight"] = torch.from_numpy(np.array(p["kernel"]).T)
            sd[f"{idx}.bias"] = torch.from_numpy(np.array(p["bias"]))
    mlp.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = mlp(torch.from_numpy(pose)).numpy()
    assert got.shape == want.shape == (3, 48)
    # float32 dense layers and sin/cos: a few ulps of the outputs
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
