"""The training loop (``nope_tpu/training/trainer.py``).

One process drives: the combined multi-dataset loader → host-to-device
prefetch → the train step → metric logging (JSONL, optional
TensorBoard and W&B) → checkpoints and resume → periodic geodesic
validation, with an optional parameter EMA stream and a monitored best
export.

Under a process group (``parallel.mesh.initialize_distributed``) every
rank runs this loop over the mesh of ``machine.mesh_data`` x
``machine.mesh_template``: the batch stays global (``machine.batch_size``
pairs a step, as the JAX trainer puts it on the data axis), each rank
loads its slice of it, the step averages the gradients over the data
axis, and with ``machine.zero1`` the optimizer state is split over it.
The metric log, the checkpoints and the best export are rank 0's; media
grids are rank-suffixed; every rank updates the same EMA.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from nope_tpu_torch.data.pipeline import CombinedLoader, device_prefetch
from nope_tpu_torch.parallel.mesh import DATA_AXIS, create_mesh, process_index
from nope_tpu_torch.parallel.zero import zero1_state_shardings
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask
from nope_tpu_torch.training.checkpoint import CheckpointManager, save_reference_checkpoint
from nope_tpu_torch.training.optim import make_lr_schedule, make_optimizer
from nope_tpu_torch.training.train_state import (
    TrainState,
    create_train_state,
    device_batch,
    make_train_step,
    to_numpy_metrics,
)


class MetricLogger:
    """JSONL metric stream, plus tensorboardX and W&B where they import
    (each imported here, when the logger is made, never at module import).
    W&B is on when a project name is configured, as the reference's
    ``WandbLogger`` (``train.py:34``)."""

    def __init__(
        self,
        save_dir: str,
        wandb_project: Optional[str] = None,
        wandb_api_key: Optional[str] = None,
        wandb_config: Optional[dict] = None,
    ):
        os.makedirs(save_dir, exist_ok=True)
        self._jsonl = open(os.path.join(save_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(os.path.join(save_dir, "tb"))
        except ImportError:
            self._tb = None
        self._wandb = None
        if wandb_project:
            # the reference's env-var handoff (train.py:34); the previous
            # value is restored so the key never stays exported
            prev_key = os.environ.get("WANDB_API_KEY")
            try:
                if wandb_api_key:
                    os.environ["WANDB_API_KEY"] = wandb_api_key
                import wandb

                self._wandb = wandb.init(project=wandb_project, dir=save_dir, config=wandb_config or {})
            except Exception as e:  # an optional sink: report it, log to JSONL/TB
                logging.warning("wandb requested but unavailable (%s); logging to JSONL/TB only", e)
            finally:
                if wandb_api_key:
                    if prev_key is None:
                        os.environ.pop("WANDB_API_KEY", None)
                    else:
                        os.environ["WANDB_API_KEY"] = prev_key

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": int(step)}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in record.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "step"}, step=step)

    def log_image(self, key: str, path: str, step: int) -> None:
        """A media grid to W&B (``model.py:164``); without W&B the PNG on
        disk is the record."""
        if self._wandb is not None:
            try:
                import wandb

                self._wandb.log({key: wandb.Image(path)}, step=step)
            except Exception as e:  # an optional sink must not stop training
                logging.warning("wandb image log failed: %s", e)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class _NoLogger:
    """The metric log of a rank other than 0: the records are rank 0's."""

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        pass

    def log_image(self, key: str, path: str, step: int) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    """The JAX package's ``Trainer``: the task's modules (their device is
    the rank's) are the train state's.  ``train_loaders`` are
    ``DataLoader``s of the global batch; on a data axis of more than one
    rank each is told to load the rank's slice."""

    def __init__(
        self,
        cfg,
        task: PoseConditionalTask,
        train_loaders: Dict[str, Iterable],
        val_fn: Optional[Callable[[TrainState], Dict[str, float]]] = None,
    ):
        optim = cfg.model.optim_config
        self.cfg = cfg
        self.task = task
        self.device = task.device
        self.mesh = create_mesh(data=cfg.machine.mesh_data, template=cfg.machine.mesh_template)
        self.rank = process_index()
        if self.mesh.data > 1:
            for loader in train_loaders.values():
                loader.shard(self.mesh.index(DATA_AXIS), self.mesh.data)
        self.combined = CombinedLoader(train_loaders)
        self.val_fn = val_fn

        steps_per_epoch = len(self.combined)
        self.tx = make_optimizer(
            task.unet.parameters(),
            optim_name=optim.optim_name,
            base_lr=optim.lr,
            weight_decay=optim.weight_decay,
            warm_up_steps=optim.warm_up_steps,
            milestones_epochs=optim.milestones_epochs,
            gamma=optim.gamma,
            steps_per_epoch=steps_per_epoch,
            clip_grad_norm=optim.clip_grad_norm,
            skip_spike_factor=getattr(optim, "skip_spike_factor", 0.0),
        )
        # the LR stream for the metric log (LearningRateMonitor analogue)
        self.lr_schedule = make_lr_schedule(
            base_lr=optim.lr,
            warm_up_steps=optim.warm_up_steps,
            milestones_epochs=optim.milestones_epochs,
            gamma=optim.gamma,
            steps_per_epoch=steps_per_epoch,
        )
        # ZeRO-1 (machine.zero1): the optimizer state split over the data axis
        self._state_shardings = None
        if getattr(cfg.machine, "zero1", False):
            self._state_shardings = zero1_state_shardings(TrainState(0, task.unet, task.vae, self.tx), self.mesh)
        self.ema_decay = float(getattr(optim, "ema_decay", 0.0) or 0.0)
        self.ema_params: Optional[torch.nn.Module] = None  # the EMA U-Net, made by init_state
        self.train_step = make_train_step(
            task,
            half_precision=getattr(optim, "half_precision_train", False),
            state_shardings=self._state_shardings,
            ema_decay=self.ema_decay,
            mesh=self.mesh,
        )
        user = getattr(cfg, "user", None)
        self.logger = MetricLogger(
            cfg.save_dir,
            wandb_project=getattr(user, "wandb_project_name", None),
            wandb_api_key=getattr(user, "wandb_api_key", None),
            wandb_config={"name_exp": cfg.name_exp},
        ) if self.rank == 0 else _NoLogger()
        self.ckpt = CheckpointManager(
            os.path.join(cfg.save_dir, "checkpoints"),
            save_interval_steps=cfg.trainer.checkpoint_every_n_steps,
            max_to_keep=cfg.trainer.keep_checkpoints,
        )
        # reconstruction grids every N steps (model.py:141-166); 0 disables
        self.media_every_n_steps = getattr(cfg.trainer, "media_every_n_steps", 1000)
        # monitored best export (ModelCheckpoint monitor/mode); best.json
        # keeps the whole run's best across resumes
        self.monitor = getattr(cfg.trainer, "monitor", "") or ""
        self.monitor_mode = getattr(cfg.trainer, "monitor_mode", "min")
        self._best = {"value": None, "step": -1, "stream": ""}
        self._best_json = os.path.join(cfg.save_dir, "checkpoints", "best.json")
        if self.monitor and os.path.exists(self._best_json):
            with open(self._best_json) as f:
                self._best = json.load(f)
            logging.info("best-checkpoint tracker resumed: %s=%s at step %s (%s)", self.monitor,
                         self._best["value"], self._best["step"], self._best["stream"])

    def _log_media(self, state: TrainState, batches, step: int) -> None:
        """A reference | query | prediction grid of the first dataset's
        batch, under ``<save_dir>/media``."""
        try:
            from nope_tpu_torch.utils.visualization import save_image_grid, unnormalize

            name, batch = next(iter(batches.items()))

            # the uint8 wire is normalised here, as the step does
            ref, query = (device_batch(batch[k][:4], self.device).float() for k in ("reference", "query"))
            task = PoseConditionalTask(state.unet, state.vae, self.task.config)
            _, pred_rgb = task.sample(ref, batch["relativeR"][:4].float(), decode_rgb=True)
            if pred_rgb is None:  # an encoder without a decoder
                return
            # rank-suffixed (model.py:146) so ranks on shared storage never collide
            path = os.path.join(self.cfg.save_dir, "media", f"reconst_step{step}_rank{self.rank}.png")
            save_image_grid(
                [unnormalize(ref.cpu().numpy()), unnormalize(query.cpu().numpy()), pred_rgb.float().cpu().numpy()],
                path,
            )
            self.logger.log_image(f"reconstruction/train_{name}", path, step)
            logging.info("media grid written: %s", path)
        except Exception:  # media logging must never stop training
            logging.warning("media logging failed", exc_info=True)

    def _update_best(self, step: int, streams) -> None:
        """If a stream improves ``cfg.trainer.monitor``, export its U-Net
        and VAE to ``<save_dir>/checkpoints/best.pth`` (the reference
        format, :func:`training.checkpoint.restore_params` reads it) and
        persist the tracker in ``best.json``."""
        sign = -1.0 if self.monitor_mode == "max" else 1.0
        winner = None
        for stream, st, scores in streams:
            if self.monitor not in scores:
                logging.warning("monitor key %r missing from val scores %s", self.monitor, sorted(scores))
                continue
            v = float(scores[self.monitor])
            best_v = self._best["value"]
            if best_v is None or sign * v < sign * float(best_v):
                self._best = {"value": v, "step": step, "stream": stream}
                winner = st
        if winner is None or self.rank != 0:
            return
        best_path = os.path.join(self.cfg.save_dir, "checkpoints", "best.pth")
        save_reference_checkpoint(best_path, winner.unet.state_dict(), winner.vae.state_dict())
        with open(self._best_json, "w") as f:
            json.dump({**self._best, "monitor": self.monitor}, f)
        logging.info("best checkpoint updated: %s=%s at step %d (%s) -> %s", self.monitor,
                     self._best["value"], step, self._best["stream"], best_path)

    # -- state ------------------------------------------------------------

    def init_state(self, resume: bool = True) -> TrainState:
        """The train state over the task's modules; with ``resume`` and a
        checkpoint in ``<save_dir>/checkpoints``, restored from the newest
        (with its EMA stream where the run keeps one)."""
        state = create_train_state(self.task, self.tx)
        ema = None
        if resume and self.ckpt.latest_step() is not None:
            logging.info("resuming from step %s", self.ckpt.latest_step())
            if self.ema_decay:
                state, ema = self.ckpt.restore_with_ema(state, _frozen_copy(state.unet))
                if ema is None:
                    logging.warning("checkpoint has no EMA stream (pre-EMA run?); seeding EMA from the restored params")
            else:
                state = self.ckpt.restore(state)
        if self.ema_decay:
            self.ema_params = ema if ema is not None else _frozen_copy(state.unet)
        return state

    # -- loop ------------------------------------------------------------

    def fit(self, state: Optional[TrainState] = None, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        state = self.init_state() if state is None else state
        max_steps = max_steps or cfg.trainer.max_steps or (cfg.trainer.max_epochs * len(self.combined))

        if self.val_fn is not None and cfg.trainer.num_sanity_val_steps > 0:
            logging.info("sanity validation...")
            self.val_fn(state)

        step = state.step
        if step:
            # deterministic resume of the data stream: every loader where an
            # uninterrupted run would be after `step` steps
            self.combined.set_state(step)
        first_step = step
        # the log's steps_per_sec divides by the steps taken since t_last
        t_last, s_last, first_s = time.perf_counter(), step, None
        while step < max_steps:
            for batches in device_prefetch(iter(self.combined), self.device, depth=2):
                if self.ema_decay:
                    state, metrics, self.ema_params = self.train_step(state, batches, self.ema_params)
                else:
                    state, metrics = self.train_step(state, batches)
                step = state.step
                if step == first_step + 1:
                    _synchronize(self.device)
                    now = time.perf_counter()
                    first_s = now - t_last
                    logging.info("first step done in %.1f s (warm-up included)", first_s)
                    t_last, s_last = now, step

                if step % cfg.trainer.log_every_n_steps == 0:
                    logged = to_numpy_metrics(metrics)  # one host read, which waits for the step
                    now = time.perf_counter()
                    logged["steps_per_sec"] = (step - s_last) / (now - t_last) if step > s_last else 1.0 / first_s
                    logged["lr"] = float(self.lr_schedule(step))
                    t_last, s_last = now, step
                    self.logger.log(step, logged)

                if step % cfg.trainer.checkpoint_every_n_steps == 0:
                    self.ckpt.save(step, state, ema_params=self.ema_params if self.ema_decay else None)

                if self.media_every_n_steps and step % self.media_every_n_steps == 0:
                    self._log_media(state, batches, step)

                if self.val_fn is not None and step % cfg.trainer.val_check_interval == 0:
                    scores = self.val_fn(state)
                    self.logger.log(step, {f"val/{k}": v for k, v in scores.items()})
                    streams = [("inst", state, scores)]
                    if self.ema_decay:
                        # the EMA stream evaluated alongside (diffusion-eval convention)
                        ema_state = dataclasses.replace(state, unet=self.ema_params)
                        ema_scores = self.val_fn(ema_state)
                        self.logger.log(step, {f"val_ema/{k}": v for k, v in ema_scores.items()})
                        streams.append(("ema", ema_state, ema_scores))
                    if self.monitor:
                        self._update_best(step, streams)

                if step >= max_steps:
                    break
        self.ckpt.wait()
        return state


def _frozen_copy(module: torch.nn.Module) -> torch.nn.Module:
    return copy.deepcopy(module).requires_grad_(False)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
