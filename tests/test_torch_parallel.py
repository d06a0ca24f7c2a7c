"""``nope_tpu_torch.parallel`` against ``nope_tpu.parallel`` on the CPU at
the tiny ``tests/torch_port_helpers.py`` size.  One 2-rank and one
4-rank gloo group (``tests/torch_parallel_ranks.parallel_rank``, torch
only) run every scenario once, while the parent computes the JAX
package's results on its 8 virtual devices:

- the template-parallel streaming eval at meshes (1, 2), (2, 1) and
  (2, 2), and the materialised variant, against JAX's sharded streaming
  eval and its single-device retrieval: float32, rtol = atol = 2e-4
  (``tests/test_parallel.py``), top-k equal;
- the 2-rank data-parallel train step against JAX's single-device step
  on the whole batch (``jax.default_matmul_precision("highest")``):
  losses rtol 1e-5, weight deltas as ``tests/test_torch_train_step.py``
  holds them;
- ZeRO-1 against the replicated step, leaf for leaf (bitwise), its
  partition, and a coordinated checkpoint resume under ZeRO-1;
- the cross-rank eval merge: unequal shards (one rank holds no rows), a
  NaN row, and merged scores against one process's; the mesh path of
  ``evaluate_geodesic`` against one process's;
- ``sharded_param_bytes`` at the flagship on the ``meta`` device
  against JAX's accounting;
- the mesh's errors against JAX's, and the 2-rank dry run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.parallel import mesh as jax_mesh
from nope_tpu.parallel.eval import make_sharded_streaming_eval_fn as jax_streaming_eval
from nope_tpu.parallel.zero import sharded_param_bytes as jax_sharded_param_bytes
from nope_tpu.tasks.pose_conditional import PoseConditionalTask as JaxTask
from nope_tpu.training import optim as jax_optim
from nope_tpu.training import port
from nope_tpu.training import train_state as jax_ts
from nope_tpu_torch.data.pipeline import DataLoader
from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic
from nope_tpu_torch.geometry import rotations as rot
from nope_tpu_torch.geometry import so3_grid, transforms
from nope_tpu_torch.models.unet import PoseUNet
from nope_tpu_torch.parallel import mesh as pmesh
from nope_tpu_torch.parallel.dryrun import dryrun_multichip
from nope_tpu_torch.parallel.eval import make_sharded_streaming_eval_fn
from nope_tpu_torch.parallel.launch import Ranks
from nope_tpu_torch.parallel.zero import sharded_param_bytes
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask
from nope_tpu_torch.weights import unet_state_dict_from_jax, vae_state_dict_from_jax
from tests.torch_parallel_ranks import FP32, OPT, parallel_rank
from tests.torch_port_helpers import IMG, UNET, VAE, seeded_port_modules

torch.set_num_threads(1)
HI = functools.partial(jax.default_matmul_precision, "highest")
B, N, STEPS, B_TRAIN, EVAL_B = 4, 8, 3, 4, 4
MESHES = [(1, 2), (2, 1), (2, 2)]
KEYS = ("query", "reference", "relativeR", "relativeR_inv")


def _eval_batch(rng, b, n):
    """A grid-pose eval batch as ``tests/test_parallel.py`` builds one."""
    grid = so3_grid.load_obj_poses(0)[:n, :3, :3].astype(np.float32)
    g = torch.from_numpy(grid)
    rel = transforms.relative_rotation(g[None].repeat(b, 1, 1, 1), g[0].expand(b, n, 3, 3))
    return {"query": rng.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32),
            "reference": rng.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32),
            "gt_relativeR": rot.matrix_to_rotation_6d(g[:b]).numpy(),
            "all_relativeR": rot.matrix_to_rotation_6d(rel).numpy(),
            "query_pose": grid[:b], "template_poses": np.broadcast_to(grid, (b, n, 3, 3)).copy(),
            "symmetry": (np.arange(b) % 3).astype(np.float32)}


def _inputs():
    rng, gen = np.random.default_rng(0), torch.Generator().manual_seed(0)
    x = {"reference": rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
         "query": rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
         "bank_R": rot.matrix_to_rotation_6d(rot.random_rotations(B * N, gen)).reshape(B, N, 6).numpy(),
         "steps": np.asarray(STEPS), "eval_batches": np.asarray(2)}
    for s in range(STEPS):
        mats = rot.random_rotations(B_TRAIN, gen)
        x.update({f"train{s}_query": rng.uniform(-1, 1, (B_TRAIN, IMG, IMG, 3)).astype(np.float32),
                  f"train{s}_reference": rng.uniform(-1, 1, (B_TRAIN, IMG, IMG, 3)).astype(np.float32),
                  f"train{s}_relativeR": rot.matrix_to_rotation_6d(mats).numpy(),
                  f"train{s}_relativeR_inv": rot.matrix_to_rotation_6d(mats.transpose(-1, -2)).numpy()})
    for i in range(2):
        x.update({f"eval{i}_{k}": v for k, v in _eval_batch(rng, EVAL_B, N).items()})
    return x


def _jax_side(params, x):
    task = JaxTask(JaxPoseUNet(**UNET), JaxVAE(**VAE))
    out = {}
    with HI():
        ref, query, bank_R = (jnp.asarray(x[k]) for k in ("reference", "query", "bank_R"))
        out["single"] = task.retrieval(params, query, task.generate_template_bank(params, ref, bank_R))
        for d, t in MESHES:
            run = jax_streaming_eval(task, jax_mesh.create_mesh(data=d, template=t), chunk_size=2)
            out[f"{d}x{t}"] = run(params, ref, query, bank_R)
        tx = jax_optim.make_optimizer(**OPT)
        state = jax_ts.TrainState(jnp.zeros((), jnp.int32), params["unet"], params["vae"], tx.init(params["unet"]))
        step = jax_ts.make_train_step(task, tx)
        out["losses"], out["unets"] = [], []
        for s in range(STEPS):
            state, m = step(state, {"ds": {k: jnp.asarray(x[f"train{s}_{k}"]) for k in KEYS}})
            out["losses"].append(float(m["loss/train_avg"]))
            out["unets"].append(jax.tree.map(np.asarray, state.unet_params))
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("parallel")
    unet, vae, params = seeded_port_modules(21)
    # the ranks' weights are JAX's params carried across by nope_tpu_torch.weights
    torch.save({"unet": unet_state_dict_from_jax(params["unet"]), "vae": vae_state_dict_from_jax(params["vae"])},
               workdir / "weights.pt")
    x = _inputs()
    np.savez(workdir / "inputs.npz", **x)
    groups = {w: Ranks(parallel_rank, w, (str(workdir),), timeout=300) for w in (2, 4)}
    jax_out = _jax_side(params, x)  # while the ranks run
    task = PoseConditionalTask(unet, vae, FP32)
    eval_batches = [{k[6:]: v for k, v in x.items() if k.startswith(f"eval{i}_")} for i in range(2)]
    one = {"merged": evaluate_geodesic(task, eval_batches, refine_steps=2),
           "first": evaluate_geodesic(task, eval_batches[:1])}
    return {"ranks": {w: g.join() for w, g in groups.items()}, "jax": jax_out, "one": one, "params": params}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_streaming_eval_matches_jax(run, mesh):
    ranks = run["ranks"][mesh[0] * mesh[1]]
    want_sim, want_idx = run["jax"][f"{mesh[0]}x{mesh[1]}"]
    single_sim, single_idx = run["jax"]["single"]
    for r in ranks:
        sim, idx = r[f"stream {mesh[0]}x{mesh[1]}"]
        np.testing.assert_allclose(sim, want_sim, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(sim, single_sim, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(idx, single_idx)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_materialised_eval_matches_jax_single_device(run, mesh):
    single_sim, single_idx = run["jax"]["single"]
    for r in run["ranks"][mesh[0] * mesh[1]]:
        sim, idx = r[f"whole {mesh[0]}x{mesh[1]}"]
        np.testing.assert_allclose(sim, single_sim, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(idx, single_idx)


def test_dp_step_matches_jax_single_device(run):
    """2 ranks x 2 pairs against JAX's step on the 4 pairs: the global
    loss on both ranks (rtol 1e-5), the same weights on both ranks
    (bitwise), and the weight deltas from the shared start: after step
    1 within 1e-3 of max|Δ_jax| on the elements whose first gradient is
    >= 1e-4 of its tensor's largest (AdamW's first update is about
    sign(g)); over all steps a relative L2 distance <= 1e-3."""
    r0, r1 = (r["dp"] for r in run["ranks"][2])
    jax_out = run["jax"]
    for s in range(STEPS):
        assert r0["metrics"][s] == r1["metrics"][s]
        np.testing.assert_allclose(r0["metrics"][s]["loss/train_avg"], jax_out["losses"][s], rtol=1e-5)
    np.testing.assert_array_equal(r0["params"], r1["params"])
    view = lambda sd: port.port_pose_unet({k: v.numpy() for k, v in sd.items()}, dim_mults=UNET["dim_mults"])  # noqa: E731
    start = run["params"]["unet"]
    first = jax.tree.leaves(view(r0["first"]))
    for s in range(STEPS):
        got = [np.asarray(a) - np.asarray(b) for a, b in zip(jax.tree.leaves(view(r0["unets"][s])),
                                                               jax.tree.leaves(start))]
        want = [np.asarray(a) - np.asarray(b) for a, b in zip(jax.tree.leaves(jax_out["unets"][s]),
                                                                jax.tree.leaves(start))]
        top = max(float(np.abs(w).max()) for w in want)
        if s == 0:
            worst = max(float(np.abs(g - w)[np.abs(f) >= 1e-4 * np.abs(f).max()].max(initial=0.0))
                        for g, w, f in zip(got, want, first))
            assert worst <= 1e-3 * top, worst / top
        diff = np.concatenate([(g - w).ravel() for g, w in zip(got, want)])
        ref = np.concatenate([w.ravel() for w in want])
        assert np.linalg.norm(diff) <= 1e-3 * np.linalg.norm(ref), s


def test_zero1_matches_replicated_leaf_for_leaf(run):
    for r in run["ranks"][2]:
        assert r["zero"]["metrics"] == r["dp"]["metrics"]
        np.testing.assert_array_equal(r["zero"]["params"], r["dp"]["params"])
        # the optimizer's partition is the one sharded_param_bytes accounts for
        assert r["zero"]["partition"] == r["zero"]["accounted"]
        assert all(r["zero"]["partition"])


def test_zero1_checkpoint_resume_is_coordinated(run):
    """Rank 0 wrote the step-2 checkpoint (the state gathered onto it);
    both ranks restored it and took step 3 as the uninterrupted run."""
    for r in run["ranks"][2]:
        z = r["zero"]
        assert z["checkpoints"] == ["ckpt_00000002.pt"] and z["resumed_from"] == 2
        assert z["resumed_metrics"] == z["metrics"][2:]
        np.testing.assert_array_equal(z["resumed_params"], z["params"])


def test_sharded_param_bytes_flagship_against_jax():
    """The 192-wide U-Net's AdamW state, 8-way.  Replicated: the two
    moments agree to the byte; the port adds AdamW's float32 step count
    per parameter, JAX a few scalar counters.  ZeRO-1: JAX splits each
    leaf of >= 16,384 elements 1/8 and keeps the smaller ones whole on
    every chip; torch gives whole parameters to ranks, so its largest
    share differs from JAX's by at most one parameter's moments plus the
    small leaves JAX keeps whole.  Both cut the moments >= 7x."""
    with torch.device("meta"):
        unet = PoseUNet(u_net_dim=192, channels=4, dim_mults=(1, 2, 4, 8))
    params = list(unet.parameters())
    got = sharded_param_bytes(params, pmesh.Mesh(8, 1))
    jax_params = jax.eval_shape(lambda: JaxPoseUNet(u_net_dim=192, channels=4, dim_mults=(1, 2, 4, 8)).init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 6))))["params"]
    opt_state = jax.eval_shape(jax_optim.make_optimizer().init, jax_params)

    class Fake:
        pass

    fake = Fake()
    fake.opt_state = opt_state
    want = jax_sharded_param_bytes(fake, jax_mesh.create_mesh(data=8, template=1))
    moments = 2 * sum(p.numel() * p.element_size() for p in params)
    leaves = jax.tree.leaves(opt_state)
    assert got["opt_state_replicated"] == moments + 4 * len(params)
    assert want["opt_state_replicated"] == moments + sum(l.size * l.dtype.itemsize for l in leaves if l.ndim == 0)
    small = sum(l.size * l.dtype.itemsize for l in leaves if 0 < l.size < 16_384)
    largest = 2 * max(p.numel() * p.element_size() for p in params) + 4
    assert abs(got["opt_state_zero1"] - want["opt_state_zero1"]) <= largest + small
    for b in (got, want):
        assert b["opt_state_zero1"] * 7 < b["opt_state_replicated"]


def test_merge_keeps_unequal_shards_and_nan_rows(run):
    """Rank 0 held 3 rows (one of them NaN), rank 1 none: both ranks get
    rank 0's rows, the NaN row kept, and the loss sums and counts."""
    want = np.array([[1, 2, 3, 4, 5], [np.nan] * 5, [7, 8, 9, 10, 11]], np.float32)
    for r in run["ranks"][2]:
        rows, loss_sum, count = r["merge"]
        np.testing.assert_array_equal(rows, want)
        assert (loss_sum, count) == (1.5, 1)


def _same_scores(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if "accuracy" in key or key == "num_images":
            assert got[key] == value, key
        elif "median" in key:
            assert abs(got[key] - value) <= 1e-3, key
        elif key == "loss":
            np.testing.assert_allclose(got[key], value, rtol=1e-5)


@pytest.mark.parametrize("path", ["eval merged", "eval mesh 2x1", "eval mesh 1x2"])
def test_eval_across_ranks_matches_one_process(run, path):
    """Two eval batches of 4 (with two refine steps), scored by 2 ranks:
    each rank its half of every batch, merged (the refined column rides
    the gather), or every batch over a (2, 1) or (1, 2) mesh; against
    one process: accuracies and counts equal, medians within 1e-3°, the
    loss within rel 1e-5 (its batch means are taken over other rows)."""
    for r in run["ranks"][2]:
        _same_scores(r[path], run["one"]["merged"])
        assert r[path]["num_images"] == 2 * EVAL_B


def test_rank_without_rows_gets_the_merged_scores(run):
    for r in run["ranks"][2]:
        _same_scores(r["eval one rank"], run["one"]["first"])


def test_ranks_import_torch_only(run):
    for world, ranks in run["ranks"].items():
        assert [r["foreign"] for r in ranks] == [[]] * world


def test_mesh_errors_match_jax():
    jax_devices = jax.devices()
    for (data, template), devices in (((2, 1), 1), ((1, 0), 1), ((0, 1), 1)):
        with pytest.raises(ValueError) as want:
            jax_mesh.create_mesh(data=data, template=template, devices=jax_devices[:devices])
        with pytest.raises(ValueError) as got:
            pmesh.create_mesh(data=data, template=template)
        assert str(got.value) == str(want.value)
    # an eval batch that the data or the template axis does not divide
    jmesh = jax_mesh.create_mesh(data=2, template=2, devices=jax_devices[:4])
    batch = {"query": np.zeros((4, 2)), "all_relativeR": np.zeros((4, 8, 6))}
    for bad in ({"query": np.zeros((3, 2))}, {"all_relativeR": np.zeros((4, 3, 6))}):
        b = {**batch, **bad}
        with pytest.raises(ValueError) as want:
            jax_mesh.shard_eval_batch(b, jmesh)
        with pytest.raises(ValueError) as got:
            pmesh.shard_eval_batch(b, pmesh.Mesh(2, 2))
        assert str(got.value) == str(want.value)


def test_streaming_eval_rejects_an_indivisible_grid_as_jax():
    """An up-front error for a grid the template axis does not divide
    (``tests/test_parallel.py``), before any U-Net work or collective."""
    b, n = 2, 10  # 10 % 4 != 0
    args = (np.zeros((b, IMG, IMG, 3), np.float32), np.zeros((b, IMG, IMG, 3), np.float32), np.zeros((b, n, 6)))
    with pytest.raises(ValueError) as want:
        jax_streaming_eval(JaxTask(JaxPoseUNet(**UNET), JaxVAE(**VAE)), jax_mesh.create_mesh(data=2, template=4),
                           chunk_size=2)(None, *args)
    unet, vae, _ = seeded_port_modules(21)
    with pytest.raises(ValueError) as got:
        make_sharded_streaming_eval_fn(PoseConditionalTask(unet, vae, FP32), pmesh.Mesh(2, 4), chunk_size=2)(*args)
    assert str(got.value) == str(want.value)


def test_one_process_mesh_and_slices():
    """Without a process group: a (1, 1) mesh with no groups, a barrier
    that returns, and the rank's slices of host arrays."""
    mesh = pmesh.create_mesh()
    assert (mesh.data, mesh.template, mesh.groups) == (1, 1, {})
    pmesh.process_barrier("unit")
    mesh = pmesh.Mesh(2, 2, rank=3)  # data index 1, template index 1
    x = np.arange(4 * 8).reshape(4, 8)
    np.testing.assert_array_equal(pmesh.data_sharding(mesh, 2)(x), x[2:])
    np.testing.assert_array_equal(pmesh.template_sharding(mesh)(x), x[:, 4:])
    np.testing.assert_array_equal(pmesh.replicate(mesh)(x), x)
    got = pmesh.shard_batch({"ds": {"a": x, "b": x[:, 0]}}, mesh)
    np.testing.assert_array_equal(got["ds"]["a"], x[2:])
    np.testing.assert_array_equal(got["ds"]["b"], x[2:, 0])
    local = pmesh.shard_eval_batch({"all_relativeR": x, "query": x, "k": np.float32(1)}, mesh)
    np.testing.assert_array_equal(local["all_relativeR"], x[2:, 4:])
    np.testing.assert_array_equal(local["query"], x[2:])
    with pytest.raises(ValueError, match="not divisible by the data mesh axis"):
        pmesh.data_sharding(pmesh.Mesh(3, 1))(x)


def test_loader_loads_the_rank_part_of_every_global_batch():
    """Every rank follows the one seeded shuffle and loads its part of each
    global batch; the parts are disjoint and make the batch; resume by
    ``set_state`` keeps it; a batch size the data axis does not divide
    raises JAX's message (``nope_tpu/parallel/mesh.py:131-135``)."""
    items = [{"i": np.asarray(i)} for i in range(12)]

    def loader(part=None):
        dl = DataLoader(items, batch_size=4, shuffle=True, seed=3, num_workers=1)
        return dl if part is None else dl.shard(part, 2)

    whole = [b["i"].tolist() for b in loader()]
    parts = [[b["i"].tolist() for b in loader(p)] for p in (0, 1)]
    assert [a + b for a, b in zip(*parts)] == whole
    resumed = loader(1)
    resumed.set_state(0, 2)
    assert [b["i"].tolist() for b in resumed] == parts[1][2:]
    with pytest.raises(ValueError, match=r"batch size 4 is not divisible by the data mesh axis \(3\)"):
        DataLoader(items, batch_size=4).shard(0, 3)


def test_dryrun_two_ranks():
    report = dryrun_multichip(2, timeout=240)
    assert report["mesh"] == (1, 2) and report["top_k_equal"]
