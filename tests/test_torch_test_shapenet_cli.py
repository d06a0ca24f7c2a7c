"""The port's ShapeNet evaluation CLI against ``nope_tpu.cli.test_shapenet``
on the same synthetic root and the same weights (CPU, float32): scores,
``scores.json`` and the per-batch ``.npz`` dumps; the checkpoint forms
the JAX CLI's torch branch reads; the device and mesh flags."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import nope_tpu.utils.env
from nope_tpu.cli import test_shapenet as jax_cli
from nope_tpu.configs import load_config as jax_load_config
from nope_tpu.models.factory import build_task as jax_build_task
from nope_tpu.training import port
from nope_tpu.training.checkpoint import save_params
from nope_tpu_torch.cli import test_shapenet as cli
from nope_tpu_torch.configs import load_config
from nope_tpu_torch.models.factory import build_task
from nope_tpu_torch.training.checkpoint import UNET_PREFIX, restore_eval_params, save_reference_checkpoint
from nope_tpu_torch.weights import unet_state_dict_from_jax, vae_state_dict_from_jax
from tests.fixtures import N_QUERY, make_mini_shapenet

torch.set_num_threads(1)
CATEGORIES = ("bottle", "mug")
OBJECTS = 2
# the model and loader overrides of tests/test_end_to_end.py's TINY_OVERRIDES
TINY = [
    "model.img_size=32", "model.u_net.u_net_dim=8", "model.u_net.dim_mults=1,2",
    "model.u_net.resnet_block_groups=4", "model.encoder.block_out_channels=8,8,8,8",
    "model.encoder.layers_per_block=1", "model.encoder.norm_groups=4", "machine.batch_size=2",
    "machine.num_workers=2",
]
FP32 = ["model.testing_config.half_precision_eval=false"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_mini_shapenet(str(tmp_path_factory.mktemp("cli_root")), categories=CATEGORIES,
                              objects_per_cat=OBJECTS)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded JAX params of the tiny model, saved both ways: an orbax
    directory (JAX) and a reference-format torch file (port)."""
    out = tmp_path_factory.mktemp("cli_weights")
    params = jax.device_get(jax_build_task(jax_load_config(None, TINY).model).init(jax.random.key(7),
                                                                                  image_size=32))
    save_params(str(out / "orbax"), params)
    save_reference_checkpoint(str(out / "nope.pth"), unet_state_dict_from_jax(params["unet"]),
                              vae_state_dict_from_jax(params["vae"]))
    return params, str(out / "orbax"), str(out / "nope.pth")


def _data(root):
    return [f"data.datasets.shapeNet.root_dir={root}", "data.datasets.shapeNet.img_size=32"]


def _dumps(save_dir):
    pred = os.path.join(save_dir, "predictions")
    out = {}
    for name in sorted(os.listdir(pred)):
        with np.load(os.path.join(pred, name)) as d:
            out[name] = {k: d[k] for k in d.files}
    return out


def test_cli_matches_jax(root, weights, tmp_path, monkeypatch, capsys):
    """fp32, fast protocol, both categories whole: the JAX CLI's scores,
    ``scores.json`` and dumps."""
    _, orbax_dir, pth = weights
    monkeypatch.setattr(nope_tpu.utils.env, "enable_compilation_cache", lambda path=None: None)
    args = [*TINY, *FP32, *_data(root)]
    with jax.default_matmul_precision("highest"):
        jax_cli.main(["--categories", ",".join(CATEGORIES), *args, f"model.checkpoint_path={orbax_dir}",
                      f"save_dir={tmp_path / 'jax'}"])
    got = cli.main(["--categories", ",".join(CATEGORIES), "--device", "cpu", *args, f"model.checkpoint_path={pth}",
                    f"save_dir={tmp_path / 'port'}"])
    capsys.readouterr()
    save = {name: str(tmp_path / name / "train") for name in ("jax", "port")}
    want = json.loads(open(os.path.join(save["jax"], "scores.json")).read())
    assert json.loads(open(os.path.join(save["port"], "scores.json")).read()) == got
    assert set(got) == set(want) == {*CATEGORIES, "mean"}
    for cat in (*CATEGORIES, "mean"):
        assert set(got[cat]) == set(want[cat]), cat
        for key, value in want[cat].items():
            if "accuracy" in key:
                assert got[cat][key] == value, (cat, key)
            elif "median" in key:
                assert abs(got[cat][key] - value) <= 1e-3, (cat, key)
            elif key == "loss":
                np.testing.assert_allclose(got[cat][key], value, rtol=1e-4)
            elif key == "num_images":
                assert got[cat][key] == value == OBJECTS * N_QUERY
    jd, pd = _dumps(save["jax"]), _dumps(save["port"])
    assert sorted(pd) == sorted(jd) == sorted(f"pred_{c}_batch{i}_rank0.npz" for c in CATEGORIES for i in range(3))
    for name in jd:
        assert set(pd[name]) == set(jd[name]), name
        np.testing.assert_array_equal(pd[name]["nearest_idx"], jd[name]["nearest_idx"])
        np.testing.assert_array_equal(pd[name]["query_pose"], jd[name]["query_pose"])
        np.testing.assert_allclose(pd[name]["similarity"], jd[name]["similarity"], rtol=1e-4)
        np.testing.assert_allclose(pd[name]["error_deg"], jd[name]["error_deg"], atol=1e-3)


@pytest.mark.parametrize("protocol", [
    [],
    ["data.datasets.shapeNet.fast_evaluation=false", "--chunk-size", "31", "--max-batches", "1"],
])
def test_cli_bf16_schema(root, weights, tmp_path, protocol, capsys):
    """The default bf16 evaluation, fast protocol and full protocol
    streamed in chunks: the schema of the scores and of the dumps."""
    _, _, pth = weights
    flags, overrides = protocol[1:], protocol[:1]
    got = cli.main(["--categories", "bottle", "--device", "cpu", *flags, *TINY, *_data(root), *overrides,
                    f"model.checkpoint_path={pth}", f"save_dir={tmp_path}"])
    capsys.readouterr()
    n = 26 if not protocol else 341
    batches = 3 if not protocol else 1
    assert set(got) == {"bottle", "mean"}
    scores = got["bottle"]
    assert scores["num_images"] == 2 * batches
    assert {f"top{k}, {m}" for k in (1, 3, 5) for m in ("accuracy_15", "accuracy_30", "median")} <= set(scores)
    assert all(np.isfinite(v) for v in scores.values())
    dumps = _dumps(str(tmp_path / "train"))
    assert sorted(dumps) == [f"pred_bottle_batch{i}_rank0.npz" for i in range(batches)]
    for d in dumps.values():
        assert d["similarity"].shape == (2, n) and d["nearest_idx"].shape == (2, 5)
        assert d["error_deg"].shape == (2,) and d["query_pose"].shape == (2, 3, 3)


def test_checkpoint_forms_of_the_jax_cli(weights, tmp_path):
    """A bare U-Net state dict and a file without VAE keys load as the
    JAX CLI's torch branch loads them (``port.port_pose_unet`` of the
    same state dict); the VAE stays as built when its keys are absent.
    An orbax directory is refused."""
    params, orbax_dir, pth = weights
    cfg = load_config(None, TINY)
    full = torch.load(pth, weights_only=True)["state_dict"]
    unet_sd = {k[len(UNET_PREFIX):]: v for k, v in full.items()
               if k.startswith(UNET_PREFIX) and not k.startswith(UNET_PREFIX + "encoder.encoder.")}
    # the JAX CLI's U-Net from this state dict, back in the port's names
    jax_unet = port.port_pose_unet({k: v.numpy() for k, v in unet_sd.items()}, dim_mults=(1, 2),
                                   pose_mlp_name="single_layer")
    want_unet = unet_state_dict_from_jax(jax.tree.map(np.asarray, jax_unet))
    files = {
        "bare": {"state_dict": unet_sd},
        "no_vae": {"state_dict": {UNET_PREFIX + k: v for k, v in unet_sd.items()}},
    }
    for name, payload in files.items():
        torch.save(payload, tmp_path / f"{name}.pth")
        task = build_task(cfg.model, torch.device("cpu"), torch.Generator().manual_seed(0))
        built_vae = {k: v.clone() for k, v in task.vae.state_dict().items()}
        assert restore_eval_params(str(tmp_path / f"{name}.pth"), task) is False
        got = task.unet.state_dict()
        assert set(got) == set(want_unet), name
        for k in want_unet:
            assert torch.equal(got[k], want_unet[k]), (name, k)
        for k, v in task.vae.state_dict().items():
            assert torch.equal(v, built_vae[k]), (name, k)
    task = build_task(cfg.model, torch.device("cpu"), torch.Generator().manual_seed(0))
    assert restore_eval_params(pth, task) is True
    want_vae = vae_state_dict_from_jax(params["vae"])
    for k, v in task.vae.state_dict().items():
        assert torch.equal(v, want_vae[k]), k
    # strict for the keys that are given
    torch.save({"state_dict": {**unet_sd, "stray.weight": torch.zeros(1)}}, tmp_path / "stray.pth")
    with pytest.raises(RuntimeError, match="stray"):
        restore_eval_params(str(tmp_path / "stray.pth"), task)
    with pytest.raises(ValueError, match="python -m nope_tpu.cli.export"):
        restore_eval_params(orbax_dir, task)


def test_cli_runs_on_the_card_by_default(root, tmp_path, monkeypatch):
    """--device defaults to cuda: with no card that is an error, not a
    quiet move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(["--categories", "bottle", *TINY, *_data(root), f"save_dir={tmp_path}"])
    assert not os.path.exists(tmp_path / "train" / "scores.json")


@pytest.mark.parametrize("flags", [["--mesh-data", "2"], ["--mesh-template", "2"]])
def test_mesh_flags_wait_for_parallel(root, tmp_path, flags):
    with pytest.raises(NotImplementedError, match="item 12"):
        cli.main(["--categories", "bottle", "--device", "cpu", *flags, *TINY, *_data(root),
                  f"save_dir={tmp_path}"])
    assert not os.path.exists(tmp_path / "train")
