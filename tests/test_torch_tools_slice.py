"""The port's tools slice end to end on the CPU at a tiny size: the port's
``generate_data`` renders a generation list through a ``blenderproc``
stand-in on ``PATH`` (``chip_smoke.write_blenderproc_standin``), the
port's training loaders read the tree (threads and grain), and
``cli.train`` takes a ``DIM=16`` step on it with each loader; and the
slice's modules import in a fresh process with jax, ``nope_tpu`` and
every optional package blocked."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import chip_smoke
from nope_tpu.scripts import generate_data as jgen
from nope_tpu_torch.cli import train as train_cli
from nope_tpu_torch.configs import load_config
from nope_tpu_torch.data import builder
from nope_tpu_torch.data.grain_pipeline import GrainLoader
from nope_tpu_torch.scripts import generate_data
from nope_tpu_torch.utils import inout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATEGORIES, VAL_OBJECTS, BATCH = 2, 2, 2
TINY = ["model.img_size=32", "model.u_net.u_net_dim=16", "model.u_net.dim_mults=1,2",
        "model.encoder.block_out_channels=8,8,8,8", "model.encoder.layers_per_block=1",
        "model.encoder.norm_groups=4", "data.datasets.shapeNet.img_size=32", f"machine.batch_size={BATCH}"]


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """A generation list of 2 training categories x 51 CADs, its block of 2
    training and 2 validation CADs rendered by ``run_generate`` with the
    stand-in first on ``PATH`` (2 spawn workers)."""
    tmp = tmp_path_factory.mktemp("generated")
    root = tmp / "root"
    start, end = chip_smoke.write_generation_list(root, CATEGORIES, VAL_OBJECTS)
    chip_smoke.write_blenderproc_standin(tmp / "bin", img_px=512)
    path = os.environ["PATH"]
    os.environ["PATH"] = f"{tmp / 'bin'}{os.pathsep}{path}"
    try:
        generate_data.run_generate(str(root), num_workers=2, start=start, end=end)
    finally:
        os.environ["PATH"] = path
    return root, start, end


def test_generate_renders_the_list_as_jax_would(generated, tmp_path):
    """652 PNGs an object (blenderproc_render.py's names), no failure, and
    pose files byte-equal to JAX's ``generate_object_poses`` for the same
    objects and diameters."""
    root, start, end = generated
    assert (root / f"failed_renderings_{start}_{end}.txt").read_text() == ""
    names, diameters = inout.open_txt(str(root / "cad_names.txt")), inout.load_json(str(root / "obj_diameter.json"))
    assert len(names) == CATEGORIES * chip_smoke.GEN_PER_CATEGORY and end - start == CATEGORIES + VAL_OBJECTS
    for obj_id in range(start, end):
        files = sorted(p.name for p in (root / "images" / f"obj_{obj_id:06d}").iterdir())
        assert len(files) == 652 and files[:5] == [f"query_{i:06d}.png" for i in range(5)]
        assert files[-1] == "templates_000641.png"
        jgen.generate_object_poses(obj_id, str(tmp_path), diameters[names[obj_id]])
        for kind in ("query", "reference", "template"):
            rel = f"object_{kind}_poses/obj_{obj_id:06d}.npy"
            assert (root / rel).read_bytes() == (tmp_path / rel).read_bytes()
    assert not (root / "images" / f"obj_{end:06d}").exists()


@pytest.mark.parametrize("loader", ["threads", "grain"])
def test_training_loaders_read_the_generated_tree(generated, loader):
    root, start, end = generated
    cfg = load_config(None, TINY + [f"data.datasets.shapeNet.root_dir={root}", f"machine.loader={loader}",
                                    "machine.num_workers=2"])
    train = builder.build_train_loaders(cfg)["shapeNet"]
    assert isinstance(train, GrainLoader) == (loader == "grain")
    assert len(train.dataset) == 5 * CATEGORIES and len(train) == 5 * CATEGORIES // BATCH
    batch = next(iter(train))
    assert batch["query"].shape == batch["reference"].shape == (BATCH, 32, 32, 3)
    assert batch["relativeR"].shape == (BATCH, 6) and np.isfinite(batch["relativeR"]).all()
    assert (batch["query"] > -1).mean() > 0.5  # the crop holds the rendered disc, not the black border
    val = builder.build_val_loaders(cfg)["shapeNet"]
    assert len(val.dataset) == 5 * VAL_OBJECTS


def test_grain_first_batch_equals_the_thread_loaders(generated):
    from nope_tpu_torch.data.pipeline import DataLoader
    from nope_tpu_torch.data.shapenet import ShapeNetDataset

    ds = ShapeNetDataset(str(generated[0]), split="training", img_size=32)
    a = next(iter(DataLoader(ds, 4, shuffle=False, num_workers=2)))
    b = next(iter(GrainLoader(ds, 4, shuffle=False, num_workers=2, shard_by_process=False)))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("loader", ["threads", "grain"])
def test_one_train_step_on_the_generated_tree(generated, loader, tmp_path):
    root = generated[0]
    state, trainer = train_cli.main(["--device", "cpu", "--max-steps", "1", *TINY,
                                     f"data.datasets.shapeNet.root_dir={root}", f"machine.loader={loader}",
                                     "machine.num_workers=2", "trainer.val_check_interval=100",
                                     "trainer.num_sanity_val_steps=0", "trainer.media_every_n_steps=0",
                                     "trainer.log_every_n_steps=1", "trainer.checkpoint_every_n_steps=100",
                                     f"save_dir={tmp_path}", "name_exp=gen"])
    assert state.step == 1 and isinstance(trainer.combined.loaders["shapeNet"], GrainLoader) == (loader == "grain")
    records = [json.loads(x) for x in open(tmp_path / "gen" / "metrics.jsonl")]
    losses = [r["loss/train_avg"] for r in records if "loss/train_avg" in r]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert (tmp_path / "gen" / "checkpoints" / "final_params.pth").is_file()


NEW_MODULES = ["nope_tpu_torch.utils.inout", "nope_tpu_torch.utils.logging", "nope_tpu_torch.utils.profiling",
               "nope_tpu_torch.utils.visualization", "nope_tpu_torch.utils.vis_3d",
               "nope_tpu_torch.scripts.generate_data", "nope_tpu_torch.scripts.generate_objaverse",
               "nope_tpu_torch.scripts.blender_objaverse", "nope_tpu_torch.scripts.download_datasets",
               "nope_tpu_torch.data.grain_pipeline", "nope_tpu_torch.data.builder"]
BLOCKED = ["jax", "nope_tpu", "matplotlib", "cv2", "PIL", "imageio", "rich", "tqdm", "open3d", "grain", "yaml",
           "bpy", "mathutils", "blenderproc", "trimesh"]


def test_new_modules_import_without_jax_or_optional_packages(tmp_path):
    """Every module of the slice imports with jax, ``nope_tpu`` and the
    optional packages blocked (``blenderproc_render.py`` runs inside
    BlenderProc and is compiled, not imported); their host paths that need
    none of them run; none of the blocked packages was loaded."""
    code = textwrap.dedent(f"""
        import importlib, logging, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        mods = {{name: importlib.import_module(name) for name in {NEW_MODULES!r}}}
        compile(open("nope_tpu_torch/scripts/blenderproc_render.py").read(), "blenderproc_render.py", "exec")
        import numpy as np, torch
        from nope_tpu_torch.utils import inout, profiling, visualization
        from nope_tpu_torch.utils import logging as nlog
        from nope_tpu_torch.scripts import blender_objaverse, generate_data
        assert visualization.similarity_heatmap(np.arange(5.0)).shape == (5, 3)
        inout.save_json({str(tmp_path / 'x.json')!r}, {{"a": np.float32(1.0)}})
        nlog.configure_preset("rich", log_dir={str(tmp_path)!r})
        assert type(logging.getLogger().handlers[0]).__name__ == "StreamHandler"
        assert profiling.benchmark(lambda: torch.ones(4).sum(), iters=2, warmup=1)["iters"] == 2.0
        generate_data.generate_object_poses(0, {str(tmp_path)!r}, 0.5)
        assert blender_objaverse.object_poses_to_blender_cam(np.eye(4)[None]).shape == (1, 4, 4)
        for call in (lambda: visualization.visualize_uncertainty(np.zeros((1, 2, 2, 1)), (4, 4)),
                     lambda: __import__("nope_tpu_torch.data.grain_pipeline").data.grain_pipeline.GrainLoader(
                         [{{"x": np.zeros(1)}}] * 4, 2).__iter__().__next__()):
            try:
                call()
                raise AssertionError("a blocked package was reachable")
            except ImportError:
                pass
        loaded = {{m.split(".")[0] for m, v in sys.modules.items() if v is not None}}
        assert not loaded & set({BLOCKED!r}), loaded & set({BLOCKED!r})
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
