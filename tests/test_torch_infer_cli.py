"""The port's single-image CLI and what it stands on, against ``nope_tpu``:
``configs.load_config`` on every YAML of ``configs/`` and on dotted
overrides, ``training.checkpoint.restore_params`` on a reference-format
torch file written from JAX params, and ``cli.infer.main`` on PNG files
(RGB and RGBA) against ``nope_tpu.cli.infer.main`` on the same weights
(CPU, float32)."""

import dataclasses
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import nope_tpu.utils.env
from nope_tpu.cli import infer as jax_infer
from nope_tpu.configs import load_config as jax_load_config
from nope_tpu.models.factory import build_task as jax_build_task
from nope_tpu.training.checkpoint import save_params
from nope_tpu_torch.cli import infer
from nope_tpu_torch.configs import load_config
from nope_tpu_torch.models.factory import build_task
from nope_tpu_torch.serving import PoseEstimator
from nope_tpu_torch.tasks import refinement as ref
from nope_tpu_torch.training.checkpoint import restore_params, save_reference_checkpoint
from nope_tpu_torch.weights import unet_state_dict_from_jax, vae_state_dict_from_jax

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))
TINY = [
    "model.img_size=32", "model.u_net.u_net_dim=16", "model.u_net.dim_mults=1,2",
    "model.encoder.block_out_channels=8,8,8,8", "model.encoder.layers_per_block=1",
    "model.encoder.norm_groups=4", "model.testing_config.half_precision_eval=false",
]


@pytest.mark.parametrize("path", YAMLS)
def test_load_config_matches_jax_on_each_yaml(path):
    want = jax_load_config(str(REPO / path))
    got = load_config(str(REPO / path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("overrides", [
    TINY,
    ["name_exp=probe", "machine.batch_size=4", "model.optim_config.lr=1e-4", "model.u_net.pretrained_path=null",
     "trainer.max_steps=10", "test_data_name=shapeNet,bop", "model.optim_config.milestones_epochs=5,7"],
    ["data.datasets.shapeNet.root_dir=/data/x", "data.datasets.shapeNet.fast_evaluation=false",
     "machine.root_dir=/mnt/r"],
])
def test_load_config_matches_jax_on_overrides(overrides):
    for path in (None, str(REPO / "configs" / "train_shapenet.yaml")):
        want = jax_load_config(path, overrides)
        got = load_config(path, overrides)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), path
    with pytest.raises(ValueError, match="not key=value"):
        load_config(None, ["model.img_size"])


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX CLI's tiny task, its params from a seed, saved both ways:
    an orbax directory (JAX) and a reference-format torch file (port)."""
    root = tmp_path_factory.mktemp("weights")
    cfg = jax_load_config(None, TINY)
    params = jax.device_get(jax_build_task(cfg.model).init(jax.random.key(7), image_size=32))
    orbax_dir = str(root / "orbax")
    save_params(orbax_dir, params)
    pth = str(root / "nope.pth")
    save_reference_checkpoint(pth, unet_state_dict_from_jax(params["unet"]), vae_state_dict_from_jax(params["vae"]))
    return params, orbax_dir, pth


def test_restore_params_loads_strictly(weights, tmp_path):
    params, orbax_dir, pth = weights
    task = build_task(load_config(None, TINY).model, torch.device("cpu"), torch.Generator().manual_seed(3))
    restore_params(pth, task)
    for module, sd in ((task.unet, unet_state_dict_from_jax(params["unet"])),
                       (task.vae, vae_state_dict_from_jax(params["vae"]))):
        got = module.state_dict()
        assert set(got) == set(sd)
        for k in sd:
            assert torch.equal(got[k], sd[k]), k
    # the reference's unused final_conv.0.mlp is dropped; anything else unknown is refused
    payload = torch.load(pth, weights_only=True)
    payload["state_dict"]["u_net.final_conv.0.mlp.1.weight"] = torch.zeros(16, 64)
    torch.save(payload, tmp_path / "with_dead.pth")
    restore_params(str(tmp_path / "with_dead.pth"), task)
    payload["state_dict"]["u_net.stray.weight"] = torch.zeros(1)
    torch.save(payload, tmp_path / "stray.pth")
    with pytest.raises(RuntimeError, match="stray"):
        restore_params(str(tmp_path / "stray.pth"), task)
    torch.save(payload["state_dict"], tmp_path / "bare.pth")
    with pytest.raises(ValueError, match="no 'state_dict'"):
        restore_params(str(tmp_path / "bare.pth"), task)
    with pytest.raises(ValueError, match="python -m nope_tpu.cli.export"):
        restore_params(orbax_dir, task)


def _png(path, rng, mode):
    from PIL import Image

    channels = 4 if mode == "RGBA" else 3
    arr = rng.integers(0, 256, (48, 48, channels), dtype=np.uint8)
    if mode == "RGBA":
        arr[::3, :, 3] = 0  # transparent rows and partial alpha elsewhere
    Image.fromarray(arr, mode).save(path)
    return str(path)


def test_load_image_composites_rgba_over_black(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "a.png")
    np.testing.assert_array_equal(infer._load_image(str(tmp_path / "a.png"), 8),
                                  jax_infer._load_image(str(tmp_path / "a.png"), 8))
    want = (rgba[..., :3].astype(np.uint16) * rgba[..., 3:].astype(np.uint16) + 127) // 255
    np.testing.assert_array_equal(infer._composite_rgba_black(rgba), want)


def test_infer_cli_matches_jax(weights, tmp_path, monkeypatch):
    params, orbax_dir, pth = weights
    monkeypatch.setattr(nope_tpu.utils.env, "enable_compilation_cache", lambda path=None: None)
    rng = np.random.default_rng(1)
    reference = _png(tmp_path / "ref.png", rng, "RGBA")
    queries = [_png(tmp_path / "q0.png", rng, "RGB"), _png(tmp_path / "q1.png", rng, "RGBA")]
    args = ["--reference", reference, "--queries", *queries, "--fast", "--refine-steps", "3"]
    with jax.default_matmul_precision("highest"):
        jax_infer.main(args + ["--checkpoint", orbax_dir, "--out", str(tmp_path / "jax.json"), *TINY])
    infer.main(args + ["--checkpoint", pth, "--out", str(tmp_path / "port.json"), "--device", "cpu", *TINY])
    want, got = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("jax", "port"))
    assert got["num_templates"] == want["num_templates"] == 26
    assert len(got["results"]) == 2
    for g, w in zip(got["results"], want["results"]):
        assert set(g) == set(w) and g["query"] == w["query"]
        assert g["topk_template_idx"] == w["topk_template_idx"]
        np.testing.assert_allclose(g["similarity"], w["similarity"], rtol=1e-4)
        np.testing.assert_allclose(g["topk_relative_rotations"], w["topk_relative_rotations"], atol=1e-6)
        np.testing.assert_allclose(g["refined_relative_rotation"], w["refined_relative_rotation"], atol=1e-3)

    # the precondition of a refinement test, at the CLI's inits
    task = build_task(load_config(None, TINY).model, torch.device("cpu"), torch.Generator().manual_seed(0))
    restore_params(pth, task)
    est = PoseEstimator(task, fast_evaluation=True)
    est.register_object("object", infer._load_image(reference, 32))
    q_lat = task.encode(torch.from_numpy(np.stack([infer._load_image(q, 32) for q in queries])))
    reps = est._bank_reps["object"][[r["topk_template_idx"][0] for r in got["results"]]]
    leaf = reps.clone().requires_grad_(True)
    with ref.frozen(task.unet):
        d = ref._per_sample_objective("l2")(task.predict_latent(est._ref_latents["object"].expand(2, -1, -1, -1),
                                                                leaf), q_lat)
        (g,) = torch.autograd.grad(d.sum(), leaf)
    assert (g.abs() >= 1e-3 * g.abs().amax(1, keepdim=True)).all(), g


def test_infer_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """--device defaults to cuda: with no card that is an error, not a
    quiet move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(2)
    ref_png = _png(tmp_path / "ref.png", rng, "RGB")
    with pytest.raises(SystemExit):
        infer.main(["--reference", ref_png, "--queries", ref_png, *TINY])
    assert not os.path.exists(tmp_path / "out.json")


def test_run_takes_arrays(weights):
    """run(): uint8 arrays in, the CLI's payload out (no image files)."""
    _, _, pth = weights
    rng = np.random.default_rng(3)
    payload = infer.run(load_config(None, TINY), rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                        rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8), torch.device("cpu"),
                        checkpoint=pth, fast=True)
    assert payload["num_templates"] == 26 and [r["query"] for r in payload["results"]] == [0, 1]
    assert "refined_relative_rotation" not in payload["results"][0]
    assert np.asarray(payload["results"][1]["topk_relative_rotation6d"]).shape == (5, 6)
