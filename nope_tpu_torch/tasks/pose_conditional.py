"""The pose-conditional task (``nope_tpu/tasks/pose_conditional.py``).

Given the frozen VAE and the pose-conditioned U-Net, predict the latent
a query view would have from (reference latent, ΔR); train with L1, L2
or Gaussian-KL latent losses; sweep ΔR over a template grid into a bank
and score queries against it.  The modules own their weights, so the
methods take no ``params``.  Inputs and outputs keep the JAX package's
NHWC layout: images (B, H, W, 3), latents (B, h, w, C), banks
(B, N, h, w, C).

The encoder is frozen: :meth:`PoseConditionalTask.encode` runs without
gradient.  The losses are differentiable wherever the ops have a
backward: on the CPU (plain versions) everywhere; on the card K2 has no
backward yet, so there they run under ``torch.no_grad``.  Inference
methods run under ``torch.no_grad``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from nope_tpu_torch.models.distributions import DiagonalGaussian
from nope_tpu_torch.ops.similarity import retrieve, similarity_metric, top_k
from nope_tpu_torch.tasks.metrics import GeodesicError


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """The JAX package's ``TaskConfig``: ``optim_config`` and
    ``testing_config`` of the reference model configs."""

    loss_type: str = "l1"  # l1 | l2 | kl
    use_inv_deltaR: bool = True
    similarity_metric: str = "l2"  # the reference-quirk metric (ops.similarity)
    retrieval_k: int = 5
    using_KL: bool = False
    # bf16 inference, the JAX package's serving and eval default
    half_precision_eval: bool = True


def cast_half(x: Union[torch.Tensor, nn.Module]):
    """float32 → bfloat16: a tensor is cast; a module is copied and the
    copy cast, so the caller's float32 module stays as it was."""
    if isinstance(x, nn.Module):
        return copy.deepcopy(x).to(torch.bfloat16)
    return x.to(torch.bfloat16) if x.dtype == torch.float32 else x


class PoseConditionalTask:
    """Task logic around a (U-Net, VAE) pair of modules on one device."""

    def __init__(self, unet: nn.Module, vae: nn.Module, config: TaskConfig = TaskConfig()):
        self.unet = unet
        self.vae = vae
        self.config = config
        self.metric = GeodesicError()

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def half(self) -> "PoseConditionalTask":
        """A bfloat16 copy of this task (``cast_half`` of both modules).
        Each copy lays out K3's weights anew at first use, so build it
        once and reuse it."""
        return PoseConditionalTask(cast_half(self.unet), cast_half(self.vae), self.config)

    # -- building blocks ----------------------------------------------------

    @torch.no_grad()
    def encode(self, images: torch.Tensor, mode: Optional[str] = "mode"):
        """Frozen VAE encode: (B, H, W, 3) → (B, h, w, C) scaled latent
        mean, or with ``mode=None`` the distribution (mean scaled)."""
        return self.vae.encode_image(images, mode)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, h, w, C) → images (B, H, W, 3)."""
        return self.vae.decode_latent(latents)

    def predict_latent(self, ref_latent: torch.Tensor, relativeR: torch.Tensor) -> torch.Tensor:
        """U-Net: (reference latent (B,h,w,C), ΔR (B, pose_dim)) → (B,h,w,C')."""
        out = self.unet(ref_latent.permute(0, 3, 1, 2), relativeR)
        return out.permute(0, 2, 3, 1).contiguous()

    def _latent_loss(self, pred: torch.Tensor, target) -> torch.Tensor:
        """L1/L2 mean, or the Gaussian KL when the target is a distribution
        (``model.py:96-104``)."""
        loss_type = self.config.loss_type
        if loss_type == "l1":
            return torch.mean(torch.abs(pred - target))
        if loss_type == "l2":
            return torch.mean(torch.square(pred - target))
        if loss_type == "kl":
            return torch.mean(DiagonalGaussian.from_parameters(pred).kl(other=target))
        raise ValueError(loss_type)

    # -- training ------------------------------------------------------------

    def forward_loss(self, query: torch.Tensor, reference: torch.Tensor,
                     relativeR: torch.Tensor) -> torch.Tensor:
        """One direction's loss (``model.py:106-111``)."""
        target = self.encode(query, None if self.config.using_KL else "mode")
        pred = self.predict_latent(self.encode(reference, "mode"), relativeR)
        return self._latent_loss(pred, target)

    def train_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The symmetrized loss of one dataset's batch (``model.py:126-137``):
        keys query, reference, relativeR (+ relativeR_inv with
        ``use_inv_deltaR``).  Without KL both directions share the encodes
        and run as one doubled U-Net batch (the same mean)."""
        query, reference = batch["query"], batch["reference"]
        if not self.config.use_inv_deltaR:
            return self.forward_loss(query, reference, batch["relativeR"])
        if self.config.using_KL:
            loss_fwd = self.forward_loss(query, reference, batch["relativeR"])
            loss_inv = self.forward_loss(reference, query, batch["relativeR_inv"])
            return (loss_fwd + loss_inv) / 2
        q_lat, r_lat = self.encode(query, "mode"), self.encode(reference, "mode")
        pred = self.predict_latent(torch.cat([r_lat, q_lat]),
                                   torch.cat([batch["relativeR"], batch["relativeR_inv"]]))
        return self._latent_loss(pred, torch.cat([q_lat, r_lat]))

    def multi_dataset_loss(
        self, batches: Dict[str, Dict[str, torch.Tensor]]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The mean over the per-dataset batches of one step (``model.py:169-182``)."""
        losses = {name: self.train_loss(b) for name, b in batches.items()}
        return sum(losses.values()) / len(losses), losses

    # -- inference -----------------------------------------------------------

    @torch.no_grad()
    def sample(self, reference: torch.Tensor, relativeR: torch.Tensor, decode_rgb: bool = False):
        """The predicted latent and, with ``decode_rgb``, its decoded image
        in [0, 1] (``model.py:113-124``)."""
        pred = self.predict_latent(self.encode(reference, "mode"), relativeR)
        rgb = torch.clamp((self.decode(pred) + 1.0) * 0.5, 0.0, 1.0) if decode_rgb else None
        return pred, rgb

    @torch.no_grad()
    def generate_template_bank(
        self,
        reference: Optional[torch.Tensor],
        bank_relativeR: torch.Tensor,
        chunk_size: Optional[int] = None,
        reference_latent: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Predicted latents for all template rotations: (B, N, h, w, C).

        ``bank_relativeR`` is (B, N, pose_dim).  The reference is encoded
        once; the N axis runs in chunks of ``chunk_size`` templates per
        U-Net forward (all N at once when None)."""
        if reference_latent is None:
            reference_latent = self.encode(reference)
        b, n = bank_relativeR.shape[:2]
        h, w = reference_latent.shape[1:3]
        chunk = n if chunk_size is None or chunk_size >= n else chunk_size
        if n % chunk:
            raise ValueError(f"chunk_size {chunk_size} must divide bank size {n}")
        flat_ref = reference_latent.repeat_interleave(chunk, dim=0)  # (B·chunk, h, w, C)
        parts = []
        for i in range(0, n, chunk):
            pose = bank_relativeR[:, i:i + chunk].reshape(b * chunk, -1)
            parts.append(self.predict_latent(flat_ref, pose).reshape(b, chunk, h, w, -1))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    @torch.no_grad()
    def stream_similarity(
        self, query_latent: torch.Tensor, reference_latent: torch.Tensor,
        bank_relativeR: torch.Tensor, chunk_size: int,
    ) -> torch.Tensor:
        """(B, N) similarity from latents, one chunk of templates at a time:
        each chunk's (B·chunk) predictions are scored as they are made, so
        the (B, N, h, w, C) bank never exists.  Every metric reduces per
        template, so this equals scoring the whole bank."""
        b, n = bank_relativeR.shape[:2]
        h, w = reference_latent.shape[1:3]
        if n % chunk_size:
            raise ValueError(f"chunk_size {chunk_size} must divide bank size {n}")
        flat_ref = reference_latent.repeat_interleave(chunk_size, dim=0)
        metric = similarity_metric(self.config.similarity_metric)
        sims = []
        for i in range(0, n, chunk_size):
            pose = bank_relativeR[:, i:i + chunk_size].reshape(b * chunk_size, -1)
            pred = self.predict_latent(flat_ref, pose).reshape(b, chunk_size, h, w, -1)
            sims.append(metric(query_latent, pred))  # (B, chunk)
            del pred
        return torch.cat(sims, dim=1)

    @torch.no_grad()
    def retrieve_streaming(
        self,
        query: Optional[torch.Tensor],
        reference: Optional[torch.Tensor],
        bank_relativeR: torch.Tensor,
        chunk_size: int,
        reference_latent: Optional[torch.Tensor] = None,
        query_latent: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bank generation and scoring fused over template chunks
        (:meth:`stream_similarity`): (similarity (B, N), top-k idx (B, k))."""
        if reference_latent is None:
            reference_latent = self.encode(reference)
        if query_latent is None:
            query_latent = self.encode(query)
        sim = self.stream_similarity(query_latent, reference_latent, bank_relativeR, chunk_size)
        return sim, top_k(sim, self.config.retrieval_k)

    @torch.no_grad()
    def retrieval(
        self, query: Optional[torch.Tensor], template_bank: torch.Tensor,
        query_latent: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Score the query against the bank: (similarity (B, N), top-k idx (B, k)).
        The bank's leading dim may be 1 (one object's bank for every query)."""
        if query_latent is None:
            query_latent = self.encode(query)
        return retrieve(query_latent, template_bank, k=self.config.retrieval_k,
                        metric=self.config.similarity_metric)

    # -- evaluation ----------------------------------------------------------

    @torch.no_grad()
    def eval_geodesic_step(
        self,
        batch: Dict[str, torch.Tensor],
        chunk_size: Optional[int] = None,
        refine_steps: int = 0,
        infer_task: Optional["PoseConditionalTask"] = None,
    ) -> Dict[str, Any]:
        """One batch of the geodesic eval (``model.py:268-376``): the loss,
        the template bank, retrieval and the symmetry-aware errors.

        ``batch`` keys, tensors on this task's device: query, reference,
        gt_relativeR, all_relativeR (B, N, pose_dim), query_pose (B, 3, 3),
        template_poses (B, N, 3, 3) (one grid, shared), symmetry (B,).

        The loss runs on these modules and the float32 images; retrieval
        on ``infer_task`` (default: :meth:`half` with
        ``half_precision_eval``, else this task), with images and poses
        cast to its dtype.  With ``chunk_size`` < N retrieval streams
        (:meth:`retrieve_streaming`); otherwise the bank is made whole.
        """
        if refine_steps:
            raise NotImplementedError("pose refinement is ROADMAP queue 1 item 10")
        loss = self.forward_loss(batch["query"], batch["reference"], batch["gt_relativeR"])
        half = self.config.half_precision_eval
        if infer_task is None:
            infer_task = self.half() if half else self
        cast = cast_half if half else (lambda t: t)
        reference, query = cast(batch["reference"]), cast(batch["query"])
        all_rel = cast(batch["all_relativeR"])
        if chunk_size is not None and chunk_size < all_rel.shape[1]:
            similarity, nearest = infer_task.retrieve_streaming(query, reference, all_rel, chunk_size)
        else:
            bank = infer_task.generate_template_bank(reference, all_rel, chunk_size=chunk_size)
            similarity, nearest = infer_task.retrieval(query, bank)
            del bank
        pred_R = batch["template_poses"][0][nearest]  # (B, k, 3, 3), the grid is shared
        symmetry = batch["symmetry"].reshape(-1)
        error, acc = self.metric(pred_R, batch["query_pose"], symmetry)
        return {
            "loss": loss,
            "similarity": similarity.float(),
            "nearest_idx": nearest,
            "error_deg": error,
            "errors_topk": self.metric.topk_errors(pred_R, batch["query_pose"], symmetry),
            **acc,
        }
