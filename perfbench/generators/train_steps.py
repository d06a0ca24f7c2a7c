"""The training generator: the port's own ``Trainer.fit`` over a
ShapeNet-layout root written from the seed (``perfbench/shapenet_root.py``).

Its mix's parameters: ``batch`` pairs a step; ``root``, the root's sizes;
``optim``, the schedule and AdamW's constants beside the configuration's
``optim`` (``lr``, ``weight_decay``); ``overrides``, dotted keys of the
port's experiment configuration set as ``cli.train`` sets them (the
loader, the trainer's intervals); ``check_steps`` steps judged, and
``check_items`` of their items whose data stage is judged;
``trace_seconds`` profiled.  The task is the configuration's program side
with the seed's state dict; the loaders are ``build_train_loaders``'s,
as ``cli.train`` builds them; no validation, checkpoint or media runs in
the window.

The first ``check_steps`` steps are set-up: the first builds and warms
every kernel, and their losses, batches, the first gradient (from
AdamW's first moment after one step) and each weight's change after the
last are kept for the judge, who follows them with the reference from
the seed's weights on the same batches.

``train_pairs_per_s``: the pairs of the window's whole steps over their
time.  The window opens at the call of step ``check_steps`` + 1 (its
batch pulled) and closes at the call of the first step due past
``--seconds``, which does not run; every step reads its loss on the host.
Beside the loader's waits, the host seconds inside each window step's
``train_step`` call are kept (zero_grad to AdamW enqueued, with any wait
for the device inside the call), which the loader's threads or a busy
host lengthen.
"""

from __future__ import annotations

import itertools
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import inputs, shapenet_root, work
from perfbench.harness import Outcome
from perfbench.reference import crop as ref_crop
from perfbench.reference import train as ref_train


#: leaves whose first gradient in the reference is under this share of the
#: median leaf's move under AdamW by round-off alone (it divides their
#: near-zero moments by each other), so ``change_gap`` leaves them out
COUNTED_GRAD_SHARE = 1e-3


class WindowClosed(Exception):
    """Raised in the step past the window, to end ``Trainer.fit``."""


class TimedLoader:
    """The trainer's combined loader, with the host time the loop spends
    in each ``next`` recorded as (start, end)."""

    def __init__(self, inner, waits: list):
        self.inner, self.waits = inner, waits

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self):
        it = iter(self.inner)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.waits.append((t0, time.perf_counter()))
                yield batch
        finally:
            it.close()


def overrides(cfg: dict, mix: dict, root: Path, save_dir: Path) -> list:
    """The port's experiment configuration of this run as ``cli.train``'s
    dotted overrides."""
    optim = mix["optim"]
    values = {
        "save_dir": save_dir, "name_exp": "train", "data.datasets.shapeNet.root_dir": root,
        "data.datasets.shapeNet.img_size": cfg["img_size"], "machine.batch_size": mix["batch"],
        "model.optim_config.optim_name": cfg["optim"]["name"], "model.optim_config.lr": cfg["optim"]["lr"],
        "model.optim_config.weight_decay": cfg["optim"]["weight_decay"],
        "model.optim_config.warm_up_steps": optim["warm_up_steps"],
        "model.optim_config.milestones_epochs": ",".join(str(e) for e in optim["milestones_epochs"]),
        "model.optim_config.gamma": optim["gamma"], "model.optim_config.clip_grad_norm": optim["clip_grad_norm"],
        **mix["overrides"],
    }
    return [f"{k}={str(v).lower() if isinstance(v, bool) else v}" for k, v in values.items()]


def step_flops(cfg: dict, batch: int) -> float:
    """Counted FLOPs of one step over the reference's modules on the meta
    device: the U-Net's forward and backward (its weight gradients, no
    recompute) over the doubled batch, and the frozen VAE's 2·batch encodes."""
    mods = inputs.meta_modules(cfg, "reference")
    latent = cfg["img_size"] // 2 ** (len(cfg["vae"]["args"]["block_out_channels"]) - 1)
    x = torch.zeros(2, cfg["vae"]["args"]["latent_channels"], latent, latent, device="meta")
    pose = torch.zeros(2, 6, device="meta")
    unet = work.model_flops(lambda: mods["unet"](x, pose).abs().mean().backward()) / 2
    return 2 * batch * (unet + work.encode_flops_per_image(mods["vae"], cfg["img_size"]))


def first_moment_norms(opt, unet, beta1: float) -> dict:
    """Each weight's first gradient as AdamW took it, from its first moment
    after one step (m = (1−β1)·g): ‖g‖ by parameter name."""
    norms = {}
    for n, p in unet.named_parameters():
        m = opt.inner.state.get(p, {}).get("exp_avg")  # none where no step took this weight
        norms[n] = torch.linalg.vector_norm(m.double()) / (1.0 - beta1) if m is not None else float("nan")
    return {n: float(v) for n, v in norms.items()}


def run(run) -> Outcome:
    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.data.builder import build_train_loaders
    from nope_tpu_torch.training.trainer import Trainer

    mix, cfg, b, checked = run.mix, run.cfg, run.mix["batch"], run.mix["check_steps"]
    scratch = tempfile.TemporaryDirectory(prefix="perfbench_train_")
    root = Path(scratch.name) / "shapenet"
    written = shapenet_root.write(root, mix["root"], run.seed)
    task = run.program()
    start = {n: p.detach().to("cpu", copy=True) for n, p in task.unet.named_parameters()}
    tcfg = load_config(None, overrides(cfg, mix, root, Path(scratch.name) / "results"))
    trainer = Trainer(tcfg, task, build_train_loaders(tcfg), val_fn=None)
    waits, marks, calls_s = [], [], []
    trainer.combined = TimedLoader(trainer.combined, waits)
    kept = {"losses": [], "steps": [], "grad_norms": None, "change_norms": None}
    step = trainer.train_step

    calls = itertools.count()

    def timed(state, batches, *extra):
        i = next(calls)
        if i == 1:
            kept["grad_norms"] = first_moment_norms(state.opt, state.unet, mix["optim"]["betas"][0])
        if i < checked:
            kept["steps"].append({name: {k: v.detach().cpu().clone() for k, v in batch.items()}
                                  for name, batch in batches.items()})
            out = step(state, batches, *extra)
            kept["losses"].append(float(out[1]["loss/train_avg"]))
            return out
        if i == checked:
            kept["change_norms"] = {n: float(torch.linalg.vector_norm((p.detach() - start[n].to(p.device)).double()))
                                    for n, p in state.unet.named_parameters()}
            start.clear()
            marks.append(run.open_window())
        else:
            marks.append(time.perf_counter())
            if marks[-1] >= marks[0] + run.seconds:
                raise WindowClosed
        run.profile_at(marks[-1], first_step_done=True)
        t0 = time.perf_counter()
        out = step(state, batches, *extra)
        calls_s.append(time.perf_counter() - t0)
        return out

    trainer.train_step = timed
    try:
        trainer.fit(trainer.init_state(resume=False), max_steps=10**9)
    except WindowClosed:
        pass
    run.close_window()
    del trainer, task, step, timed
    steps, seconds = len(marks) - 1, marks[-1] - marks[0]
    wait = sum(min(e, marks[-1]) - max(s, marks[0]) for s, e in waits if e > marks[0] and s < marks[-1])
    window = {"seconds": seconds, "steps": steps, "loader_wait_s": wait, "step_call_s": sum(calls_s),
              "model_flops": steps * step_flops(cfg, b) if run.spans else None}
    optim = dict(mix["optim"], lr=cfg["optim"]["lr"], weight_decay=cfg["optim"]["weight_decay"])
    followed = {}

    def reference_of(side) -> dict:
        if id(side) not in followed:
            with side.exact():
                followed[id(side)] = ref_train.adamw_steps(side.unet, side.vae, kept["steps"], optim, side.device)
        return followed[id(side)]

    gen = inputs.rng(run.seed, 9)
    items = [(int(s), int(r)) for s, r in zip(gen.integers(0, checked, mix["check_items"]),
                                              gen.integers(0, b, mix["check_items"]))]
    data = {"data_gap": max(item_gap(kept["steps"][s], r, written, cfg["img_size"]) for s, r in items)}

    def judge(side, stand_in=None):
        want = reference_of(side)
        got = kept if stand_in is None else reference_of(stand_in)
        scratch.cleanup()  # here, once the loader's threads have long left the root
        return dict(compare(got, want), **data)

    return Outcome({"train_pairs_per_s": steps * b / seconds}, steps * b, 0, window, judge)


def item_gap(batches: dict, row: int, written: dict, size: int, tol: float = 1e-5) -> float:
    """The data stage, judged by itself on one consumed item: the widest
    gap, in uint8 levels, between the item's query and reference images
    and the reference's crops (``reference/crop.py``) of the written views
    whose grid poses give the item's ΔR and ΔR⁻¹ (within ``tol``), the
    best-fitting pair of one object; inf where no written pair gives them."""
    batch = next(iter(batches.values()))
    images = {k: batch[k][row].numpy() for k in ("query", "reference")}
    images = {k: v if v.dtype == np.uint8 else np.rint((v.astype(np.float64) + 1.0) / 2.0 * 255.0)
              for k, v in images.items()}
    rel, rel_inv = (batch[k][row].double().numpy() for k in ("relativeR", "relativeR_inv"))
    grid = shapenet_root.grid_poses()
    rots = grid[:, :3, :3]
    pairs = np.argwhere(np.abs(inputs.rotation_6d(np.einsum("aij,bkj->abik", rots, rots)) - rel).max(-1) < tol)
    crops = {}

    def gap(kind, pose, views, kinds):
        best = float("inf")
        for k in {int(k) for name in kinds for k in views[name][1][views[name][0] == pose]}:
            if (k, pose) not in crops:
                crops[k, pose] = ref_crop.crop(written["pool"][k], grid[pose], size).astype(np.float64)
            best = min(best, float(np.abs(crops[k, pose] - images[kind]).max()))
        return best

    best = float("inf")
    for a, b in pairs:
        if np.abs(inputs.rotation_6d(rots[b] @ rots[a].T) - rel_inv).max() >= tol:
            continue
        for views in written["views"].values():
            best = min(best, max(gap("query", a, views, ("query",)),
                                 gap("reference", b, views, ("query", "reference", "template"))))
    return best


def compare(got: dict, want: dict) -> dict:
    """``loss_rel``: the widest relative gap of the steps' losses;
    ``grad_gap``: the worst leaf's gap between the norms of the first
    gradients, over the larger of the reference's norm of that leaf and of
    the median leaf; ``change_gap``: the same of the weights' change after
    the last step, over the leaves whose first gradient in the reference is
    at least ``COUNTED_GRAD_SHARE`` of the median leaf's."""
    loss_rel = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
    if len(got["losses"]) != len(want["losses"]):
        loss_rel = float("inf")
    g_want = want["grad_norms"]
    g_med = statistics.median(g_want.values())
    grad_gap = max(abs(got["grad_norms"][n] - w) / max(w, g_med) for n, w in g_want.items())
    counted = [n for n, w in g_want.items() if w >= COUNTED_GRAD_SHARE * g_med]
    c_med = statistics.median(want["change_norms"][n] for n in counted)
    change_gap = max(abs(got["change_norms"][n] - want["change_norms"][n]) / max(want["change_norms"][n], c_med)
                     for n in counted)
    return {name: float(v) if np.isfinite(v) else float("inf")
            for name, v in (("loss_rel", loss_rel), ("grad_gap", grad_gap), ("change_gap", change_gap))}
