"""Shared tiny configurations for the nope_tpu_torch parity tests: the
JAX model, its seeded params, and the same weights in the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu_torch.models.unet import PoseUNet
from nope_tpu_torch.models.vae import StableDiffusionVAE
from nope_tpu_torch.weights import unet_state_dict_from_jax, vae_state_dict_from_jax

UNET = dict(u_net_dim=16, channels=4, dim_mults=(1, 2), resnet_block_groups=8)
VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1, latent_channels=4, groups=4)
LATENT_HW = 16
IMG = 32


@functools.lru_cache(maxsize=None)
def jax_unet_params(seed: int = 0):
    model = JaxPoseUNet(**UNET)
    return model.init(
        jax.random.key(seed), jnp.zeros((1, LATENT_HW, LATENT_HW, 4)), jnp.zeros((1, 6))
    )["params"]


@functools.lru_cache(maxsize=None)
def jax_vae_params(seed: int = 1):
    return JaxVAE(**VAE).init(jax.random.key(seed), jnp.zeros((1, IMG, IMG, 3)))["params"]


def torch_unet(params) -> PoseUNet:
    model = PoseUNet(**UNET).eval()
    model.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    return model


def torch_vae(params) -> StableDiffusionVAE:
    """The whole VAE, encoder and decoder sides, loaded strictly."""
    model = StableDiffusionVAE(**VAE).eval()
    model.load_state_dict(vae_state_dict_from_jax(params), strict=True)
    return model


def seeded_port_modules(seed: int, out_dim=None):
    """Port modules with seeded weights and the same weights as JAX params,
    through ``nope_tpu.training.port`` (no JAX init to compile):
    (unet, vae, {"unet": ..., "vae": ...})."""
    from nope_tpu.training import port
    from nope_tpu_torch.models.factory import init_weights

    gen = torch.Generator().manual_seed(seed)
    unet = init_weights(PoseUNet(**UNET, out_dim=out_dim), gen).eval()
    vae = init_weights(StableDiffusionVAE(**VAE), gen).eval()
    params = {
        "unet": port.port_pose_unet(to_numpy_tree(unet.state_dict()), dim_mults=UNET["dim_mults"]),
        "vae": port.port_sd_vae(to_numpy_tree(vae.state_dict()), num_blocks=len(VAE["block_out_channels"]),
                                layers_per_block=VAE["layers_per_block"]),
    }
    return unet, vae, params


def to_numpy_tree(sd):
    return {k: v.numpy() for k, v in sd.items()}


def assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), f"{path}: {sorted(set(a) ^ set(b))}"
    for k in a:
        if isinstance(a[k], dict) or hasattr(a[k], "keys"):
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


torch.set_num_threads(1)
