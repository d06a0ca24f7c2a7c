"""nope_tpu_torch.weights: the JAX → port state-dict converters are the
exact inverses of nope_tpu.training.port, and their output loads into
the port's modules with strict=True."""

from nope_tpu.training import port
from nope_tpu_torch.weights import unet_state_dict_from_jax, vae_state_dict_from_jax
from tests.oracles.torch_pose_unet import TorchPoseUNet
from tests.torch_port_helpers import (
    UNET,
    VAE,
    assert_trees_equal,
    jax_unet_params,
    jax_vae_params,
    to_numpy_tree,
    torch_unet,
    torch_vae,
)


def test_unet_round_trip_is_bit_exact():
    params = jax_unet_params()
    sd = to_numpy_tree(unet_state_dict_from_jax(params))
    assert_trees_equal(port.port_pose_unet(sd, dim_mults=UNET["dim_mults"]), params)


def test_unet_state_dict_loads_strict_and_matches_reference_names():
    model = torch_unet(jax_unet_params())  # load_state_dict(strict=True)
    oracle = TorchPoseUNet(
        u_net_dim=UNET["u_net_dim"], channels=4, dim_mults=UNET["dim_mults"],
        groups=UNET["resnet_block_groups"],
    )
    # the reference's final_conv.0.mlp is dead weight, absent on both sides
    want = {k for k in oracle.state_dict() if not k.startswith("final_conv.0.mlp")}
    assert set(model.state_dict()) == want


def test_vae_round_trip_is_bit_exact():
    params = jax_vae_params()
    sd = to_numpy_tree(vae_state_dict_from_jax(params))
    ported = port.port_sd_vae(sd, num_blocks=len(VAE["block_out_channels"]),
                              layers_per_block=VAE["layers_per_block"])
    assert_trees_equal(ported, params)


def test_vae_encoder_side_loads_strict():
    """The encoder side and, since the decoder was ported, the whole VAE."""
    model = torch_vae(jax_vae_params())  # load_state_dict(strict=True)
    keys = set(model.state_dict())
    assert all(k.startswith(("encoder.", "quant_conv.", "decoder.", "post_quant_conv.")) for k in keys)
    assert any(k.startswith("encoder.") for k in keys) and "quant_conv.weight" in keys
    assert "decoder.up_blocks.0.resnets.1.conv2.weight" in keys and "post_quant_conv.weight" in keys
