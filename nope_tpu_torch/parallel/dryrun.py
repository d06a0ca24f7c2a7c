"""A multi-rank dry run on CPU gloo ranks (``__graft_entry__.dryrun_multichip``)::

    python -m nope_tpu_torch.parallel.dryrun [n_ranks]

Starts ``n_ranks`` CPU processes in one gloo group and, at a tiny width
(8-wide U-Net, 32-px images, 4x4 latents), runs one data-parallel train
step over all ranks, one ZeRO-1 step from the same start, and one
template-parallel streaming eval over a (n/2, 2) mesh (a (n, 1) mesh for
an odd n).  Rank 0 also runs the single-process step and retrieval on
the whole batch; the run fails unless the parallel results agree: the
loss and the averaged gradients within float32 rounding (rel 1e-5), the
ZeRO-1 step bitwise, the similarity within 1e-4 and the top-k equal.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

IMG = 32
TINY = ["model.img_size=32", "model.u_net.u_net_dim=8", "model.u_net.dim_mults=1,2",
        "model.u_net.resnet_block_groups=4", "model.encoder.block_out_channels=8,8,8,8",
        "model.encoder.layers_per_block=1", "model.encoder.norm_groups=4",
        "model.testing_config.half_precision_eval=false"]


def _pairs(b: int):
    from nope_tpu_torch.geometry import rotations

    rng = np.random.default_rng(0)
    mats = rotations.random_rotations(b, torch.Generator().manual_seed(1))
    return {"query": rng.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32),
            "reference": rng.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32),
            "relativeR": rotations.matrix_to_rotation_6d(mats).numpy(),
            "relativeR_inv": rotations.matrix_to_rotation_6d(mats.transpose(-1, -2)).numpy()}


def _dryrun_rank(rank: int, world: int, init_method: str) -> dict:
    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.geometry import rotations
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.parallel.eval import make_sharded_streaming_eval_fn
    from nope_tpu_torch.parallel.mesh import create_mesh, initialize_distributed, shard_batch
    from nope_tpu_torch.parallel.zero import zero1_state_shardings
    from nope_tpu_torch.training.optim import make_optimizer
    from nope_tpu_torch.training.train_state import create_train_state, make_train_step

    torch.set_num_threads(1)
    device = initialize_distributed("gloo", "cpu", init_method, rank, world)
    cfg = load_config(None, TINY).model

    def fresh():
        task = build_task(cfg, device, torch.Generator().manual_seed(0))
        return task, create_train_state(task, make_optimizer(task.unet.parameters(), warm_up_steps=0))

    # data parallelism over every rank, the global batch 2 pairs a rank
    mesh = create_mesh(data=world, template=1)
    batch = {"shapeNet": _pairs(2 * world)}
    out = {}
    task, state = fresh()
    _, m = make_train_step(task, mesh=mesh)(state, shard_batch(batch, mesh))
    out["loss"] = float(m["loss/train_avg"])
    task_z, state_z = fresh()
    shardings = zero1_state_shardings(state_z, mesh)
    _, m = make_train_step(task_z, state_shardings=shardings)(state_z, shard_batch(batch, mesh))
    out["zero1_loss"] = float(m["loss/train_avg"])
    out["zero1_max_param_diff"] = max(float((a - b).detach().abs().max()) for a, b in
                                      zip(state.unet.parameters(), state_z.unet.parameters()))

    # the template-parallel sweep
    template = 2 if world % 2 == 0 else 1
    mesh_e = create_mesh(data=world // template, template=template)
    b, n = 2 * mesh_e.data, 4 * template
    rng = np.random.default_rng(2)
    reference, query = (rng.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    bank_R = rotations.matrix_to_rotation_6d(rotations.random_rotations(b * n, torch.Generator().manual_seed(3)))
    bank_R = bank_R.reshape(b, n, 6)
    task_e = build_task(cfg, device, torch.Generator().manual_seed(0))
    sim, idx = make_sharded_streaming_eval_fn(task_e, mesh_e, chunk_size=2)(reference, query, bank_R)
    out["mesh"] = (mesh_e.data, mesh_e.template)
    if rank == 0:
        task1, state1 = fresh()
        _, m = make_train_step(task1)(state1, batch)
        out["single_loss"] = float(m["loss/train_avg"])
        # the averaged gradients against the whole batch's
        grads = [(a.grad, b.grad) for a, b in zip(state.unet.parameters(), state1.unet.parameters())]
        out["grad_rel"] = (max(float((a - b).abs().max()) for a, b in grads)
                           / max(float(b.abs().max()) for _, b in grads))
        want, want_idx = task_e.retrieve_streaming(torch.from_numpy(query), torch.from_numpy(reference), bank_R, n)
        out["sim_max_abs"] = float((sim - want).abs().max())
        out["top_k_equal"] = bool(torch.equal(idx, want_idx))
    return out


def dryrun_multichip(n_ranks: int, timeout: float = 300.0) -> dict:
    """Run the dry run on ``n_ranks`` gloo ranks; rank 0's report.  Raises
    if a rank fails or the parallel results disagree with one process."""
    from nope_tpu_torch.parallel.launch import run_ranks

    report = run_ranks(_dryrun_rank, n_ranks, timeout=timeout)[0]
    ok = (np.isfinite(report["loss"]) and abs(report["loss"] - report["single_loss"]) <= 1e-5 * abs(report["single_loss"])
          and report["zero1_loss"] == report["loss"] and report["zero1_max_param_diff"] == 0.0
          and report["grad_rel"] <= 1e-5 and report["sim_max_abs"] <= 1e-4 and report["top_k_equal"])
    if not ok:
        raise RuntimeError(f"the {n_ranks}-rank dry run disagrees with one process: {report}")
    return report


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
