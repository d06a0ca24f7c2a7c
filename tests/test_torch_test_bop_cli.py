"""The port's BOP / T-LESS VSD CLI against ``nope_tpu.cli.test_bop`` on the
same mini BOP root and the same weights (CPU, float32, the numpy
rasteriser): every similarity, the top-5 of every row and
``vsd_scores.json``; the bank streamed in chunks against the bank made whole; the device
flag.

``--renderer numpy`` always: a worker that collected the reference
parity tests may hold stub ``pyrender`` / ``trimesh`` modules, which
are blocked here for both packages."""

import json
import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

import nope_tpu.evaluation.vsd as jax_vsd
import nope_tpu.utils.env
from nope_tpu.cli import test_bop as jax_cli
from nope_tpu.configs import load_config as jax_load_config
from nope_tpu.models.factory import build_task as jax_build_task
from nope_tpu.tasks.pose_conditional import PoseConditionalTask as JaxTask
from nope_tpu.training.checkpoint import save_params
from nope_tpu_torch.cli import test_bop as cli
from nope_tpu_torch.data.base_bop import load_json
from nope_tpu_torch.data.png import write_png
from nope_tpu_torch.evaluation import raster
from nope_tpu_torch.evaluation import vsd as port_vsd
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask
from nope_tpu_torch.training.checkpoint import save_reference_checkpoint
from nope_tpu_torch.weights import unet_state_dict_from_jax, vae_state_dict_from_jax
from tests.fixtures import make_mini_bop

torch.set_num_threads(1)
# the DIM=16 U-Net and the VAE of tests/torch_port_helpers.py
TINY = [
    "model.img_size=32", "model.u_net.u_net_dim=16", "model.u_net.dim_mults=1,2",
    "model.u_net.resnet_block_groups=8", "model.encoder.block_out_channels=8,8,8,8",
    "model.encoder.layers_per_block=1", "model.encoder.norm_groups=4", "machine.batch_size=2",
    "machine.num_workers=2",
]
FRAMES = 5  # 5 queries in batches of 2: the last batch is ragged
# max|port - JAX| over max|JAX| of the similarities: float32 sums taken
# in another order
SIM_RTOL = 1e-4


@pytest.fixture(autouse=True)
def no_gl(monkeypatch):
    for name in ("pyrender", "trimesh", "nope_tpu.utils.mesh"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A mini BOP root whose depth maps are the box CAD's rendered GT
    depths (16-bit, 0.1 mm), so VSD scores real geometry."""
    root = make_mini_bop(str(tmp_path_factory.mktemp("bop_cli")), n_frames=FRAMES, real_cad=True)
    verts, faces = raster.load_mesh_arrays(osp.join(root, "models", "models", "obj_000001.ply"))
    scene = osp.join(root, "test", "000001")
    scene_gt = load_json(osp.join(scene, "scene_gt.json"))
    scene_cam = load_json(osp.join(scene, "scene_camera.json"))
    for frame_id, gts in scene_gt.items():
        K = np.asarray(scene_cam[frame_id]["cam_K"], np.float64).reshape(3, 3)
        pose = np.eye(4)
        pose[:3, :3] = np.asarray(gts[0]["cam_R_m2c"]).reshape(3, 3)
        pose[:3, 3] = np.asarray(gts[0]["cam_t_m2c"]).reshape(3)
        depth = raster.rasterize_depth(verts, faces, pose, K, (128, 128))
        write_png(osp.join(scene, "depth", f"{int(frame_id):06d}.png"), np.round(depth / 0.1).astype(np.uint16))
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded JAX params of the tiny model: an orbax directory (JAX) and
    the same weights as a reference-format torch file (port)."""
    out = tmp_path_factory.mktemp("bop_weights")
    params = jax.device_get(jax_build_task(jax_load_config(None, TINY).model).init(jax.random.key(3), image_size=32))
    save_params(str(out / "orbax"), params)
    save_reference_checkpoint(str(out / "nope.pth"), unet_state_dict_from_jax(params["unet"]),
                              vae_state_dict_from_jax(params["vae"]))
    return str(out / "orbax"), str(out / "nope.pth")


def _data(root):
    return [f"data.datasets.tless.root_dir={root}", "data.datasets.tless.split=test",
            "data.datasets.tless.img_size=32", "data.datasets.tless.reset_metaData=true"]


def _recording(monkeypatch, module, log):
    real = module.build_vsd_frames

    def build(batch, nearest, *args):
        log.append(np.asarray(nearest))
        return real(batch, nearest, *args)

    monkeypatch.setattr(module, "build_vsd_frames", build)


def test_cli_matches_jax(root, weights, tmp_path, monkeypatch, capsys):
    orbax_dir, pth = weights
    monkeypatch.setattr(nope_tpu.utils.env, "enable_compilation_cache", lambda path=None: None)
    jax_nearest, port_nearest, jax_sims, port_sims = [], [], [], []
    _recording(monkeypatch, jax_vsd, jax_nearest)
    _recording(monkeypatch, port_vsd, port_nearest)
    retrieval, jax_retrieval = PoseConditionalTask.retrieval, JaxTask.retrieval

    def recorded(self, *args, **kwargs):
        sim, idx = retrieval(self, *args, **kwargs)
        port_sims.append(sim.numpy())
        return sim, idx

    def jax_recorded(self, *args, **kwargs):  # traced inside the CLI's jit: the values come back by callback
        sim, idx = jax_retrieval(self, *args, **kwargs)
        jax.debug.callback(lambda s: jax_sims.append(np.asarray(s)), sim, ordered=True)
        return sim, idx

    monkeypatch.setattr(PoseConditionalTask, "retrieval", recorded)
    monkeypatch.setattr(JaxTask, "retrieval", jax_recorded)
    args = ["--renderer", "numpy", *TINY, *_data(root)]
    with jax.default_matmul_precision("highest"):
        jax_cli.main(["--chunk-size", "341", *args, f"model.checkpoint_path={orbax_dir}",
                      f"save_dir={tmp_path / 'jax'}", "name_exp=bop"])
        jax.effects_barrier()
    got = cli.main(["--device", "cpu", *args, f"model.checkpoint_path={pth}", f"save_dir={tmp_path / 'port'}",
                    "name_exp=bop"])
    out = capsys.readouterr().out
    assert "VSD renderer: numpy" in out
    want = json.loads((tmp_path / "jax" / "bop" / "vsd_scores.json").read_text())
    assert json.loads((tmp_path / "port" / "bop" / "vsd_scores.json").read_text()) == got
    assert set(got) == set(want) == {f"top {k}, {m}" for k in (1, 3, 5) for m in ("vsd_median", "vsd_scores 0.3")}

    jn, pn = np.concatenate(jax_nearest), np.concatenate(port_nearest)
    jsim, psim = np.concatenate(jax_sims), np.concatenate(port_sims)
    assert jn.shape == pn.shape == (FRAMES, 5) and jsim.shape == psim.shape == (FRAMES, 341)
    assert np.abs(psim - jsim).max() <= SIM_RTOL * np.abs(jsim).max()
    np.testing.assert_array_equal(pn, jn)
    assert got == want  # the same templates render the same depths: the same scores
    assert all(np.isfinite(v) for v in got.values())


def test_chunked_bank_and_device_flag(root, weights, tmp_path, capsys):
    """The bank streamed in chunks of 31 gives the scores of the bank made
    whole; ``--max-batches`` stops early; the default device is CUDA."""
    _, pth = weights
    args = ["--device", "cpu", "--renderer", "numpy", *TINY, *_data(root), f"model.checkpoint_path={pth}"]
    whole = cli.main([*args, f"save_dir={tmp_path / 'whole'}"])
    chunked = cli.main(["--chunk-size", "31", *args, f"save_dir={tmp_path / 'chunked'}"])
    assert chunked == whole
    one = cli.main(["--max-batches", "1", *args, f"save_dir={tmp_path / 'one'}"])
    assert set(one) == set(whole)
    capsys.readouterr()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            cli.main(["--renderer", "numpy", *TINY, *_data(root), f"save_dir={tmp_path / 'gpu'}"])
        assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(ValueError, match="chunk_size"):
        cli.main(["--chunk-size", "30", *args, f"save_dir={tmp_path / 'bad'}"])
