"""The port's training entry points (``nope_tpu_torch/cli/train.py``,
``cli/pretrain_vae.py``, ``training/pretrain_vae.py``) against the JAX
package's on the CPU at a tiny size: ``cli.train.main`` on the same
procedural ShapeNet root from the same warm start, its metrics stream
and exports, the refusals, and the VAE pretraining step with JAX's
noise handed in."""

import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from nope_tpu.cli.train import main as jax_train_main
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.training import port
from nope_tpu.training.pretrain_vae import create_vae_pretrain_state as jax_vae_state
from nope_tpu.training.pretrain_vae import make_vae_pretrain_step as jax_vae_step
from nope_tpu_torch.cli import pretrain_vae as pretrain_cli
from nope_tpu_torch.cli import train as train_cli
from nope_tpu_torch.configs import load_config
from nope_tpu_torch.data.categories import SHAPENET_CAT2ID
from nope_tpu_torch.data.shapenet import ShapeNetDataset
from nope_tpu_torch.geometry import so3_grid
from nope_tpu_torch.models.factory import build_task, init_weights
from nope_tpu_torch.models.vae import StableDiffusionVAE
from nope_tpu_torch.training import checkpoint
from nope_tpu_torch.training.pretrain_vae import create_vae_pretrain_state, make_vae_pretrain_step
from tests.fixtures import make_shapenet_object

torch.set_num_threads(1)

# a tiny model; the VAE keeps 2 layers a block, which the JAX warm start's
# port_sd_vae reads from a diffusers file
TINY = [
    "model.img_size=32",
    "model.u_net.u_net_dim=8",
    "model.u_net.dim_mults=1,2",
    "model.u_net.resnet_block_groups=4",
    "model.encoder.block_out_channels=8,8,8,8",
    "model.encoder.layers_per_block=2",
    "model.encoder.norm_groups=4",
    "model.optim_config.warm_up_steps=0",
    "model.optim_config.lr=1e-3",
    "model.optim_config.ema_decay=0.5",
    "machine.batch_size=2",
    "machine.num_workers=2",
    "trainer.num_sanity_val_steps=0",
    "trainer.media_every_n_steps=0",
    "trainer.log_every_n_steps=1",
    "trainer.checkpoint_every_n_steps=3",
    "trainer.val_check_interval=3",
]
STEPS = 3


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """A root whose 'training' split resolves to 2 materialised airplane
    objects (of 52 listed) with their level-2 template images, and whose
    'unseen_training' split to 2 more (``tests/test_train_cli.py``)."""
    root = str(tmp_path_factory.mktemp("torch_cli_shapenet"))
    rng = np.random.default_rng(0)
    with open(osp.join(root, "cad_names.txt"), "w") as f:
        f.write("\n".join(f"{SHAPENET_CAT2ID['airplane']}_c{j}" for j in range(52)) + "\n")

    class Probe(ShapeNetDataset):
        def _load_metadata(self):
            self.selected = self._selected_object_ids()
            self.query_paths = []

    train_idx, _ = so3_grid.get_obj_poses_from_template_level(2, "upper", return_index=True)
    for obj_id in list(Probe(root, split="training").selected) + list(Probe(root, split="unseen_training").selected[:2]):
        make_shapenet_object(root, obj_id, rng, train_idx, img_px=64)
    return root


@pytest.fixture(scope="module")
def warm_start(tmp_path_factory):
    """Seeded U-Net and VAE weights as the files both warm starts read: a
    bare reference U-Net state dict and a diffusers VAE directory."""
    out = tmp_path_factory.mktemp("warm")
    cfg = load_config(None, TINY)
    task = build_task(cfg.model, torch.device("cpu"), torch.Generator().manual_seed(11))
    torch.save(task.unet.state_dict(), out / "unet.pth")
    (out / "vae").mkdir()
    torch.save(task.vae.state_dict(), out / "vae" / "diffusion_pytorch_model.bin")
    return str(out / "unet.pth"), str(out / "vae"), task


def _overrides(root, save_dir, warm, name):
    return TINY + [
        f"data.datasets.shapeNet.root_dir={root}",
        "data.datasets.shapeNet.img_size=32",
        f"save_dir={save_dir}",
        f"name_exp={name}",
        "use_pretrained=true",
        f"model.u_net.pretrained_path={warm[0]}",
        f"model.encoder.pretrained_path={warm[1]}",
    ]


@pytest.fixture(scope="module")
def both_runs(train_root, warm_start, tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    jax_train_main(["--max-steps", str(STEPS)] + _overrides(train_root, out, warm_start, "jax")
                   + ["machine.mesh_data=1"])
    state, trainer = train_cli.main(["--max-steps", str(STEPS), "--device", "cpu"]
                                    + _overrides(train_root, out, warm_start, "port"))
    read = lambda name: [json.loads(l) for l in open(osp.join(out, name, "metrics.jsonl"))]  # noqa: E731,E741
    return {"jax": read("jax"), "port": read("port"), "dir": out, "state": state, "trainer": trainer}


def test_cli_losses_match_jax_from_a_shared_warm_start(both_runs):
    def losses(records):
        return {r["step"]: r["loss/train_shapeNet"] for r in records if "loss/train_shapeNet" in r}

    want, got = losses(both_runs["jax"]), losses(both_runs["port"])
    assert sorted(got) == sorted(want) == list(range(1, STEPS + 1))
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-4, err_msg=f"step {s}")
    assert want[1] != want[STEPS]


def test_cli_metrics_keys_match_jax(both_runs):
    """Every record of metrics.jsonl carries the JAX trainer's keys: the
    train records (losses, steps_per_sec, lr) and the validation records
    of both streams (val/*, val_ema/*)."""
    keys = lambda records: [sorted(r) for r in records]  # noqa: E731
    assert keys(both_runs["port"]) == keys(both_runs["jax"])
    assert any(k.startswith("val_ema/") for r in both_runs["port"] for k in r)
    lr = [r["lr"] for r in both_runs["port"] if "lr" in r]
    np.testing.assert_allclose(lr, [r["lr"] for r in both_runs["jax"] if "lr" in r], rtol=1e-7)


def test_cli_exports_load_with_restore_params(both_runs, warm_start):
    ckpts = osp.join(both_runs["dir"], "port", "checkpoints")
    state, trainer = both_runs["state"], both_runs["trainer"]
    for name, unet in (("final_params.pth", state.unet), ("final_params_ema.pth", trainer.ema_params)):
        cfg = load_config(None, TINY)
        probe = build_task(cfg.model, torch.device("cpu"), torch.Generator().manual_seed(0))
        checkpoint.restore_params(osp.join(ckpts, name), probe)
        for a, b in zip(probe.unet.state_dict().values(), unet.state_dict().values()):
            assert torch.equal(a, b)
        # the frozen VAE is the warm start's
        for a, b in zip(probe.vae.state_dict().values(), warm_start[2].vae.state_dict().values()):
            assert torch.equal(a, b)
    assert checkpoint.CheckpointManager(ckpts).latest_step() == STEPS


def test_orbax_directory_is_refused_by_name(tmp_path, warm_start):
    cfg = load_config(None, TINY + [f"model.u_net.pretrained_path={tmp_path}", "use_pretrained=true"])
    task = build_task(cfg.model, torch.device("cpu"), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="orbax"):
        train_cli._maybe_warm_start(task, cfg)


def test_old_diffusers_vae_names_are_read():
    """A diffusers<=0.14 VAE file (query/key/value/proj_attn as 1x1 convs)
    loads as the JAX package's port_sd_vae reads it."""
    vae = init_weights(StableDiffusionVAE(block_out_channels=(8, 8, 8, 8), layers_per_block=1, groups=4),
                       torch.Generator().manual_seed(3))
    new = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    old = {}
    for k, v in vae.state_dict().items():
        for a, b in new.items():
            if f".attentions.0.{a}." in k:
                k = k.replace(f".{a}.", f".{b}.")
                v = v[:, :, None, None] if v.dim() == 2 else v
        old[k] = v
    other = StableDiffusionVAE(block_out_channels=(8, 8, 8, 8), layers_per_block=1, groups=4)
    other.load_state_dict(train_cli.diffusers_vae_state_dict(old), strict=True)
    for a, b in zip(other.state_dict().values(), vae.state_dict().values()):
        assert torch.equal(a, b)


def test_cli_refusals(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            train_cli.main(["--max-steps", "1"])
        with pytest.raises(SystemExit):
            pretrain_cli.main(["--steps", "1", "--out", str(tmp_path / "vae.bin")])
    monkeypatch.setenv("WORLD_SIZE", "2")
    for main, args in ((train_cli.main, []), (pretrain_cli.main, ["--out", str(tmp_path / "v.bin")])):
        with pytest.raises(NotImplementedError, match="item 12"):
            main(args + ["--device", "cpu"])


def test_pretrain_step_matches_jax_with_its_noise():
    """Three AdamW steps of VAE pretraining from the same weights on the
    same images, the posterior noise JAX draws handed to the port."""
    cfg = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1, groups=4)
    vae = init_weights(StableDiffusionVAE(**cfg), torch.Generator().manual_seed(4))
    params = port.port_sd_vae({k: v.numpy() for k, v in vae.state_dict().items()}, layers_per_block=1)
    jvae = JaxVAE(block_out_channels=(8, 8, 8, 8), layers_per_block=1, groups=4)
    tx = optax.adamw(2e-3)
    jstate = jax_vae_state(jvae, tx, jax.random.key(0), image_size=32)._replace(
        params=jax.tree.map(jnp.asarray, params))
    jstate = jstate._replace(opt_state=tx.init(jstate.params))
    jstep = jax_vae_step(jvae, tx, recon_loss="l1", kl_weight=1e-2)
    state = create_vae_pretrain_state(vae, lr=2e-3)
    step = make_vae_pretrain_step(recon_loss="l1", kl_weight=1e-2)
    rng = np.random.default_rng(0)
    for i in range(3):
        images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8) if i == 1 else \
            rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        noise = jax.random.normal(jax.random.split(jstate.rng)[0], (2, 4, 4, 4))
        with jax.default_matmul_precision("highest"):
            jstate, want = jstep(jstate, jnp.asarray(images))
        state, got = step(state, images, noise=torch.from_numpy(np.array(noise)))
        for k in ("loss", "recon", "kl"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=f"step {i} {k}")
    assert state.step == 3


def test_pretrain_cli_writes_what_train_reads(train_root, tmp_path):
    """The pretrain CLI trains on the train loader's images and writes a
    VAE file that cli.train loads as its frozen encoder; an existing
    --out is refused before any training."""
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump({"data": {"datasets": {"shapeNet": {
        "name": "shapeNet", "root_dir": train_root, "img_size": 32}}}}))
    out = str(tmp_path / "vae.bin")
    state = pretrain_cli.main(["--config", str(cfg_path), "--steps", "2", "--out", out, "--log-every", "1",
                               "--device", "cpu"] + TINY)
    assert state.step == 2 and osp.isfile(out)
    with pytest.raises(SystemExit):
        pretrain_cli.main(["--steps", "1", "--out", out, "--device", "cpu"])
    cfg = load_config(str(cfg_path), TINY + [f"model.encoder.pretrained_path={out}", "use_pretrained=true"])
    task = build_task(cfg.model, torch.device("cpu"), torch.Generator().manual_seed(0))
    train_cli._maybe_warm_start(task, cfg)
    for a, b in zip(task.vae.state_dict().values(), state.vae.state_dict().values()):
        assert torch.equal(a, b)
