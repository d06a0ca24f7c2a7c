"""The port's export CLI against the JAX package's port tool: seeded
reference-format U-Net checkpoints (bare, ``u_net.``-prefixed, and
wrapped in ``state_dict`` with the unused ``final_conv.0.mlp``) and a
diffusers VAE (a directory, a ``.bin``, the old attention names) go
through ``cli.export`` and ``restore_params``; the U-Net's and the VAE's
outputs equal the JAX models built from ``nope_tpu.training.port.
port_pose_unet`` / ``port_sd_vae`` of the same files (float32, matmuls
at "highest"; the repo's U-Net and VAE parity tolerances); a wrong shape
raises."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.training import port
from nope_tpu_torch.cli import export
from nope_tpu_torch.configs import load_config
from nope_tpu_torch.models.factory import build_task
from nope_tpu_torch.training.checkpoint import restore_params
from tests.torch_port_helpers import IMG, LATENT_HW, UNET, VAE, seeded_port_modules

torch.set_num_threads(1)
TINY = [
    "model.img_size=32", "model.u_net.u_net_dim=16", "model.u_net.dim_mults=1,2",
    "model.u_net.resnet_block_groups=8", "model.encoder.block_out_channels=8,8,8,8",
    "model.encoder.layers_per_block=1", "model.encoder.norm_groups=4",
]
# the repo's parity tolerances: tests/test_unet_parity.py, tests/test_vae_parity.py
UNET_TOL, VAE_TOL = dict(atol=2e-4, rtol=1e-3), dict(atol=5e-5)
OLD_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Seeded weights written as the reference's files."""
    out = tmp_path_factory.mktemp("reference")
    unet, vae, _ = seeded_port_modules(21)
    unet_sd, vae_sd = unet.state_dict(), vae.state_dict()
    dead = {"final_conv.0.mlp.1.weight": torch.randn(32, 128), "final_conv.0.mlp.1.bias": torch.randn(32)}
    files = {
        "bare": {**unet_sd},
        "prefixed": {f"u_net.{k}": v for k, v in unet_sd.items()},
        "wrapped": {"state_dict": {f"u_net.{k}": v for k, v in {**unet_sd, **dead}.items()}, "epoch": 3},
    }
    paths = {}
    for name, payload in files.items():
        paths[name] = str(out / f"{name}.pth")
        torch.save(payload, paths[name])
    os.makedirs(out / "sd-vae")
    torch.save(vae_sd, out / "sd-vae" / "diffusion_pytorch_model.bin")
    old = {}
    for k, v in vae_sd.items():
        for new, was in OLD_NAMES.items():
            if ".attentions." in k and f".{new}." in k:
                k = k.replace(f".{new}.", f".{was}.")
                v = v[:, :, None, None] if v.dim() == 2 else v  # and as 1x1 convolutions
        old[k] = v
    torch.save(old, out / "old_names.bin")
    paths["vae_dir"], paths["vae_old"] = str(out / "sd-vae"), str(out / "old_names.bin")
    return paths, unet_sd, vae_sd


def _jax_outputs(unet_np, vae_np, x, pose, img):
    unet_params = port.port_pose_unet(unet_np, dim_mults=UNET["dim_mults"], pose_mlp_name="single_layer")
    vae_params = port.port_sd_vae(vae_np, num_blocks=len(VAE["block_out_channels"]),
                                  layers_per_block=VAE["layers_per_block"])
    with jax.default_matmul_precision("highest"):
        pred = JaxPoseUNet(**UNET).apply({"params": unet_params}, jnp.asarray(x), jnp.asarray(pose))
        lat = JaxVAE(**VAE).apply({"params": vae_params}, jnp.asarray(img), "mode", method=JaxVAE.encode_image)
        dec = JaxVAE(**VAE).apply({"params": vae_params}, lat, method=JaxVAE.decode_latent)
    return np.asarray(pred), np.asarray(lat), np.asarray(dec)


def _port_outputs(path, x, pose, img):
    task = build_task(load_config(None, TINY).model, torch.device("cpu"), torch.Generator().manual_seed(5))
    restore_params(path, task)
    with torch.no_grad():
        pred = task.unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(pose)).permute(0, 2, 3, 1)
        lat = task.vae.encode_image(torch.from_numpy(img))
        dec = task.vae.decode_latent(lat)
    return pred.numpy(), lat.numpy(), dec.numpy()


@pytest.mark.parametrize("unet_form, vae_form", [("bare", "vae_dir"), ("prefixed", None), ("wrapped", "vae_old")])
def test_export_matches_the_port_tool(reference, unet_form, vae_form, tmp_path, capsys):
    paths, unet_sd, vae_sd = reference
    out = str(tmp_path / "ckpt" / "nope.pth")
    args = ["--out", out, "--unet", paths[unet_form], "--device", "cpu", *TINY]
    assert export.main(args + (["--vae", paths[vae_form]] if vae_form else [])) == out
    assert f"exported params -> {out}" in capsys.readouterr().out

    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, LATENT_HW, LATENT_HW, 4)).astype(np.float32)
    pose = rng.normal(size=(2, 6)).astype(np.float32)
    img = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    got = _port_outputs(out, x, pose, img)
    # the JAX side reads the same files' tensors; without --vae both hold the task's seeded VAE
    unet_np = {k: v.numpy() for k, v in unet_sd.items()}
    if vae_form is None:
        seeded = build_task(load_config(None, TINY).model, torch.device("cpu"), torch.Generator().manual_seed(0))
        vae_np = {k: v.numpy() for k, v in seeded.vae.state_dict().items()}
    else:
        vae_np = {k: v.numpy() for k, v in vae_sd.items()}
        if vae_form == "vae_old":
            vae_np = port.load_torch_state_dict(paths["vae_old"])
    want = _jax_outputs(unet_np, vae_np, x, pose, img)
    np.testing.assert_allclose(got[0], want[0], **UNET_TOL)
    np.testing.assert_allclose(got[1], want[1], **VAE_TOL)
    np.testing.assert_allclose(got[2], want[2], **VAE_TOL)
    saved = torch.load(out, weights_only=True)["state_dict"]
    assert not any(".mlp." in k and "final_conv" in k for k in saved)
    for k, v in unet_sd.items():
        assert torch.equal(saved[f"u_net.{k}"], v), k


def test_wrong_shapes_raise(reference, tmp_path):
    paths, unet_sd, vae_sd = reference
    wide = [*TINY[:1], "model.u_net.u_net_dim=24", *TINY[2:]]
    with pytest.raises(ValueError, match="the U-Net of .* does not match"):
        export.main(["--out", str(tmp_path / "a.pth"), "--unet", paths["bare"], "--device", "cpu", *wide])
    bad = dict(vae_sd)
    bad["encoder.conv_in.weight"] = torch.zeros(4, 3, 3, 3)
    torch.save(bad, tmp_path / "bad.bin")
    with pytest.raises(ValueError, match="the VAE of .* does not match"):
        export.main(["--out", str(tmp_path / "b.pth"), "--unet", paths["bare"], "--vae", str(tmp_path / "bad.bin"),
                     "--device", "cpu", *TINY])
    missing = {k: v for k, v in unet_sd.items() if not k.startswith("init_conv")}
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(ValueError, match="init_conv"):
        export.main(["--out", str(tmp_path / "c.pth"), "--unet", str(tmp_path / "missing.pth"), "--device", "cpu",
                     *TINY])
    assert not os.path.exists(tmp_path / "a.pth")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            export.main(["--out", str(tmp_path / "d.pth"), "--unet", paths["bare"], *TINY])
