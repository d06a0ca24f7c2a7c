"""Rank programs of the multi-rank CPU tests.  Each runs in a fresh
process started by ``nope_tpu_torch.parallel.launch.Ranks``, joins a gloo
group through the ``file://`` store it is handed, and imports torch and
the port only (never jax, never ``nope_tpu``): the tests compare what the
ranks return with the JAX package in the parent process."""

import contextlib
import copy
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from nope_tpu_torch.evaluation.geodesic import _merge_across_processes, evaluate_geodesic
from nope_tpu_torch.models.unet import PoseUNet
from nope_tpu_torch.models.vae import StableDiffusionVAE
from nope_tpu_torch.parallel.eval import make_sharded_eval_fn, make_sharded_streaming_eval_fn
from nope_tpu_torch.parallel.mesh import create_mesh, initialize_distributed, shard_batch
from nope_tpu_torch.parallel.zero import zero1_partition, zero1_state_shardings
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig
from nope_tpu_torch.training.checkpoint import CheckpointManager
from nope_tpu_torch.training.optim import make_optimizer
from nope_tpu_torch.training.train_state import create_train_state, make_train_step, to_numpy_metrics

# tests/torch_port_helpers.py's tiny model (that module imports jax)
UNET = dict(u_net_dim=16, channels=4, dim_mults=(1, 2), resnet_block_groups=8)
VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1, latent_channels=4, groups=4)
OPT = dict(base_lr=1e-3, warm_up_steps=0, weight_decay=5e-4)
FP32 = TaskConfig(half_precision_eval=False)


def foreign_modules():
    """The modules of this process that the port must never import."""
    return sorted(m for m, v in sys.modules.items()
                  if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "nope_tpu"))


def join(rank, world, init_method):
    torch.set_num_threads(1)
    return initialize_distributed("gloo", "cpu", init_method, rank, world)


@contextlib.contextmanager
def one_rank_group(directory):
    """A gloo group of this process alone, for the paths that need one."""
    initialize_distributed("gloo", "cpu", f"file://{os.path.join(str(directory), 'one_rank_store')}", 0, 1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def load_modules(workdir):
    weights = torch.load(os.path.join(workdir, "weights.pt"), weights_only=True)
    unet, vae = PoseUNet(**UNET).eval(), StableDiffusionVAE(**VAE).eval()
    unet.load_state_dict(weights["unet"], strict=True)
    vae.load_state_dict(weights["vae"], strict=True)
    return unet, vae


def flat_params(module):
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()]).numpy()


def _train(unet, vae, batches, mesh, zero=False, ckpt=None, restore_from=None):
    """DP steps over ``batches`` (global), from copies of the modules:
    metrics, U-Net state dicts and first gradients per step."""
    unet, vae = copy.deepcopy(unet), copy.deepcopy(vae)
    task = PoseConditionalTask(unet, vae)
    state = create_train_state(task, make_optimizer(unet.parameters(), **OPT))
    shardings = zero1_state_shardings(state, mesh) if zero else None
    step = make_train_step(task, state_shardings=shardings, mesh=mesh)
    if restore_from is not None:
        restore_from.restore(state)
    metrics, unets, first = [], [], None
    for b in batches[state.step:]:
        state, m = step(state, shard_batch(b, mesh))
        if first is None:
            first = {n: p.grad.clone() for n, p in unet.named_parameters()}
        metrics.append(to_numpy_metrics(m))
        unets.append({k: v.clone() for k, v in unet.state_dict().items()})
        if ckpt is not None:
            ckpt.save(state.step, state)
    return metrics, unets, first, state


def _split_rows(batch, part, parts):
    return {k: np.array_split(v, parts)[part] for k, v in batch.items()}


def parallel_rank(rank, world, init_method, workdir):
    """The scenarios of ``tests/test_torch_parallel.py``."""
    join(rank, world, init_method)
    x = dict(np.load(os.path.join(workdir, "inputs.npz")))
    unet, vae = load_modules(workdir)
    task = PoseConditionalTask(unet, vae, FP32)
    out = {}
    for d, t in ([(1, 2), (2, 1)] if world == 2 else [(2, 2)]):
        mesh = create_mesh(d, t)
        for name, make in (("stream", make_sharded_streaming_eval_fn), ("whole", make_sharded_eval_fn)):
            sim, idx = make(task, mesh, chunk_size=2)(x["reference"], x["query"], x["bank_R"])
            out[f"{name} {d}x{t}"] = (sim.numpy(), idx.numpy())
    if world == 2:
        mesh = create_mesh(2, 1)
        steps = int(x["steps"])
        batches = [{"ds": {k: x[f"train{s}_{k}"] for k in ("query", "reference", "relativeR", "relativeR_inv")}}
                   for s in range(steps)]
        metrics, unets, first, state = _train(unet, vae, batches, mesh)
        out["dp"] = {"metrics": metrics, "unets": unets if rank == 0 else None, "first": first if rank == 0 else None,
                     "params": flat_params(state.unet)}
        # ZeRO-1 from the same start, with a checkpoint at step 2 and a coordinated resume from it
        ckpt = CheckpointManager(os.path.join(workdir, "zero_ckpt"), save_interval_steps=2)
        zm, _, _, zstate = _train(unet, vae, batches, mesh, zero=True, ckpt=ckpt)
        partition = [[p for g in groups for p in g["params"]] for groups in zstate.opt.inner._partition_parameters()]
        ids = {id(p): i for i, p in enumerate(zstate.unet.parameters())}
        rm, _, _, rstate = _train(unet, vae, batches, mesh, zero=True,
                                  restore_from=CheckpointManager(os.path.join(workdir, "zero_ckpt")))
        out["zero"] = {"metrics": zm, "params": flat_params(zstate.unet), "resumed_metrics": rm,
                       "resumed_params": flat_params(rstate.unet), "resumed_from": steps - len(rm),
                       "partition": [sorted(ids[id(p)] for p in part) for part in partition],
                       "accounted": [sorted(p) for p in zero1_partition(zstate.unet.parameters(), 2)],
                       "checkpoints": sorted(os.listdir(os.path.join(workdir, "zero_ckpt")))}
        # the merge: rank 0 holds three rows (one NaN), rank 1 none
        k = 5
        rows = np.array([[1, 2, 3, 4, 5], [np.nan] * k, [7, 8, 9, 10, 11]], np.float32)
        out["merge"] = _merge_across_processes(rows if rank == 0 else np.zeros((0, k), np.float32),
                                               1.5 if rank == 0 else 0.0, 1 if rank == 0 else 0, k)
        eval_batches = [{k[len(f"eval{i}_"):]: v for k, v in x.items() if k.startswith(f"eval{i}_")}
                        for i in range(int(x["eval_batches"]))]
        out["eval merged"] = evaluate_geodesic(task, [_split_rows(b, rank, world) for b in eval_batches],
                                               refine_steps=2)
        out["eval one rank"] = evaluate_geodesic(task, eval_batches[:1] if rank == 0 else [])
        for d, t in ((2, 1), (1, 2)):
            out[f"eval mesh {d}x{t}"] = evaluate_geodesic(task, eval_batches, chunk_size=2, mesh=create_mesh(d, t),
                                                          refine_steps=2)
    out["foreign"] = foreign_modules()
    return out


def shapenet_cli_rank(rank, world, init_method, runs):
    """``cli.test_shapenet.main`` once per argument list in ``runs``."""
    from nope_tpu_torch.cli import test_shapenet

    join(rank, world, init_method)
    results = [test_shapenet.main(args) for args in runs]
    return {"results": results, "foreign": foreign_modules()}


def train_cli_rank(rank, world, init_method, runs):
    """In turn: ``cli.train.main(args)`` (``("train", args)``: the final
    step, U-Net and mesh), ``cli.pretrain_vae.main(args)`` (``("pretrain",
    args)``: the final step and VAE state dict), and a copy of one file by rank 0
    (``("copy", (src, dst))``) that every rank waits for."""
    import shutil

    from nope_tpu_torch.cli import pretrain_vae, train
    from nope_tpu_torch.parallel.mesh import process_barrier

    join(rank, world, init_method)
    out = []
    for kind, args in runs:
        if kind == "train":
            state, trainer = train.main(args)
            out.append({"step": state.step, "params": flat_params(state.unet), "mesh": trainer.mesh.shape,
                        "sharded": state.opt.sharded})
        elif kind == "pretrain":
            state = pretrain_vae.main(args)
            out.append({"step": state.step, "state": state.vae.state_dict()})
        else:
            if rank == 0:
                os.makedirs(os.path.dirname(args[1]), exist_ok=True)
                shutil.copy(*args)
            process_barrier("copied")
            out.append(None)
    return {"runs": out, "foreign": foreign_modules()}


GRAIN_RECORDS, GRAIN_BATCH, GRAIN_STEPS = 32, 8, 2  # GrainPairs' records
GRAIN_TINY = ["model.img_size=32", "model.u_net.u_net_dim=8", "model.u_net.dim_mults=1,2",
              "model.u_net.resnet_block_groups=4", "model.encoder.block_out_channels=8,8,8,8",
              "model.encoder.layers_per_block=1", "model.encoder.norm_groups=4",
              "model.optim_config.warm_up_steps=2", "trainer.num_sanity_val_steps=0",
              "trainer.media_every_n_steps=0", "trainer.log_every_n_steps=1",
              "trainer.checkpoint_every_n_steps=100", f"machine.batch_size={GRAIN_BATCH}"]


def grain_fit(save_dir, loader, overrides=()):
    """A tiny ``Trainer.fit`` of ``GRAIN_STEPS`` steps over ``loader``;
    returns (loss per step, flat weights)."""
    import json

    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.training.trainer import Trainer

    cfg = load_config(None, GRAIN_TINY + [f"save_dir={save_dir}", "name_exp=run", *overrides])
    task = build_task(cfg.model, torch.device("cpu"), torch.Generator().manual_seed(cfg.trainer.seed))
    trainer = Trainer(cfg, task, {"pairs": loader})
    state = trainer.fit(trainer.init_state(resume=False), max_steps=GRAIN_STEPS)
    trainer.logger.close()
    losses = None
    if os.path.exists(os.path.join(cfg.save_dir, "metrics.jsonl")):
        with open(os.path.join(cfg.save_dir, "metrics.jsonl")) as f:
            losses = [r["loss/train_avg"] for r in map(json.loads, f) if "loss/train_avg" in r]
    return losses, flat_params(state.unet), len(trainer.combined)


def grain_rank(rank, world, init_method, workdir):
    """One rank of 2: the ``GrainLoader`` alone (a record shard per rank,
    batches of its batch size, 2 worker processes), then under the
    data-parallel ``Trainer`` (``machine.batch_size`` the step's global
    batch: ``GRAIN_BATCH / world`` records a rank a step)."""
    # grain imports jax and orbax where they are installed; the port's grain path needs neither
    sys.modules["jax"] = sys.modules["orbax"] = None
    from nope_tpu_torch.data.grain_pipeline import GrainLoader
    from tests.grain_datasets import GrainPairs

    join(rank, world, init_method)
    alone = GrainLoader(GrainPairs(), batch_size=4, num_workers=2, seed=11)
    alone_ids = [b["_idx"].tolist() for b in alone]
    fetched = []

    def log_ids(batch):
        fetched.append(batch.pop("_idx").tolist())
        return batch

    loader = GrainLoader(GrainPairs(), batch_size=GRAIN_BATCH, seed=11, post_batch_fn=log_ids)
    losses, params, steps = grain_fit(os.path.join(workdir, f"rank{rank}"), loader, ["machine.mesh_data=2"])
    return {"alone": alone_ids, "alone_len": len(alone), "fetched": fetched, "losses": losses, "params": params,
            "steps_per_epoch": steps, "foreign": foreign_modules()}
