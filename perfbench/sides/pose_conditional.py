"""The three sides of a pose-conditioned configuration (a U-Net over a
VAE's latents, ``tasks/pose_conditional.py``): the program's task, the
reference and the control, which the configuration names under
``sides``.

``program`` builds the program's ``PoseConditionalTask`` from the
configuration's classes and the seed's state dict.  ``Reference`` builds
the configuration's reference modules (``perfbench/reference``, plain
PyTorch, float32, TF32 off) from the same state dict and recomputes what
the program should have answered.  ``Control`` is the reference one
precision lower, put in the program's place (``reference/lowp.py``).
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from perfbench import inputs
from perfbench.reference import lowp
from perfbench.reference import task as ref


def program(run):
    """The program's task, given the seed's state dict (strictly: every
    tensor drawn is loaded, and none of the program's is left out)."""
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig

    built = inputs.load(inputs.meta_modules(run.cfg, "program"), inputs.state_for(run.cfg, run.seed, run.device),
                        run.device)
    task = PoseConditionalTask(built["unet"], built["vae"], TaskConfig(**run.cfg["task"]))
    if run.spans:
        run.spans.watch_task(task.unet, task.vae)
    return task


BLOCK = 64


class Reference:
    """The configuration's reference modules, float32, from the seed."""

    def __init__(self, cfg: dict, seed: int, device: torch.device):
        built = inputs.load(inputs.meta_modules(cfg, "reference"), inputs.state_for(cfg, seed, device), device,
                            frozen=True)
        self.unet, self.vae, self.device = built["unet"], built["vae"], device
        self.dtype = torch.float32
        self._stated = None

    def stated(self) -> "Reference":
        """This reference at the bank's stated precision, bfloat16."""
        if self._stated is None:
            self._stated = copy.copy(self)
            self._stated.unet, self._stated.vae = (copy.deepcopy(m).to(torch.bfloat16) for m in (self.unet, self.vae))
            self._stated.dtype = torch.bfloat16
        return self._stated

    def exact(self):
        return contextlib.nullcontext()

    def images(self, x: np.ndarray) -> torch.Tensor:
        """Images as the program takes them: uint8 normalised to [-1, 1]
        in float32, float as they are; then in this side's dtype."""
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        t = t.float() / 127.5 - 1.0 if t.dtype == torch.uint8 else t.float()
        return t.to(self.dtype)

    @torch.no_grad()
    def encode(self, x: np.ndarray) -> torch.Tensor:
        return torch.cat([self.vae.encode_image(self.images(x[i:i + BLOCK])) for i in range(0, len(x), BLOCK)])

    @torch.no_grad()
    def similarity_row(self, ref_image: np.ndarray, query_image: np.ndarray, rel6: np.ndarray) -> torch.Tensor:
        """(N,) float32: the query's "l2" score against the bank of one
        reference image over the (N, 6) poses."""
        r_lat, q_lat = self.encode(ref_image[None]), self.encode(query_image[None])
        pose = torch.from_numpy(np.ascontiguousarray(rel6)).to(self.device, self.dtype)
        sims = []
        for i in range(0, len(pose), BLOCK):
            p = pose[i:i + BLOCK]
            pred = ref.predict_latent(self.unet, r_lat.expand(len(p), -1, -1, -1), p)
            sims.append(ref.l2_similarity(q_lat.float(), pred.float()[None])[0])
        return torch.cat(sims)

    @torch.no_grad()
    def eval_loss(self, batch: dict) -> float:
        """The evaluation step's float32 L1 loss over the whole batch."""
        with self.exact():
            target = self.encode(batch["query"]).float()
            r_lat = self.encode(batch["reference"])
            pose = torch.from_numpy(batch["gt_relativeR"]).to(self.device, self.dtype)
            pred = torch.cat([ref.predict_latent(self.unet, r_lat[i:i + BLOCK], pose[i:i + BLOCK])
                              for i in range(0, len(pose), BLOCK)])
            return float(ref.l1_loss(pred.float(), target))

    def rotations(self, r: np.ndarray) -> np.ndarray:
        return r


class Control(Reference):
    """The reference one precision below the configuration's: the
    bfloat16 bank on float8 convs and linears, the float32 loss on TF32,
    the rotation metric on bfloat16-rounded rotations."""

    def __init__(self, cfg: dict, seed: int, device: torch.device):
        super().__init__(cfg, seed, device)
        self.exact_unet, self.exact_vae = self.unet, self.vae
        self.unet, self.vae = lowp.fp8_copy(self.unet), lowp.fp8_copy(self.vae)
        self.dtype = torch.bfloat16

    def exact(self):
        return _swap(self, lowp.tf32())

    def rotations(self, r: np.ndarray) -> np.ndarray:
        return lowp.bf16_round(torch.from_numpy(np.ascontiguousarray(r))).numpy()


@contextlib.contextmanager
def _swap(side: Control, precision):
    """The control's float32 modules, dtype and TF32 for a float32 stage."""
    saved = side.unet, side.vae, side.dtype
    side.unet, side.vae, side.dtype = side.exact_unet, side.exact_vae, torch.float32
    try:
        with precision:
            yield
    finally:
        side.unet, side.vae, side.dtype = saved
