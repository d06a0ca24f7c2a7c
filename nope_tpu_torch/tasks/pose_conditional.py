"""The pose-conditional task at inference (``nope_tpu/tasks/pose_conditional.py``).

Given the frozen VAE and the pose-conditioned U-Net, predict the latent
a query view would have from (reference latent, ΔR); sweep ΔR over a
template grid into a bank; score queries against it.  The modules own
their weights, so the methods take no ``params``.  Inputs and outputs
keep the JAX package's NHWC layout: images (B, H, W, 3), latents
(B, h, w, C), banks (B, N, h, w, C).

Only the inference path is ported; the losses, ``sample`` and the
streaming retrieval are later work (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from nope_tpu_torch.ops.similarity import retrieve


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """The inference fields of the JAX package's ``TaskConfig``."""

    similarity_metric: str = "l2"  # the reference-quirk metric (ops.similarity)
    retrieval_k: int = 5
    # bf16 inference, the JAX package's serving default
    half_precision_eval: bool = True


def cast_half(x: Union[torch.Tensor, nn.Module]):
    """float32 → bfloat16: a tensor is cast; a module is copied and the
    copy cast, so the caller's float32 module stays as it was."""
    if isinstance(x, nn.Module):
        return copy.deepcopy(x).to(torch.bfloat16)
    return x.to(torch.bfloat16) if x.dtype == torch.float32 else x


class PoseConditionalTask:
    """Inference logic around a (U-Net, VAE) pair of modules on one device."""

    def __init__(self, unet: nn.Module, vae: nn.Module, config: TaskConfig = TaskConfig()):
        self.unet = unet
        self.vae = vae
        self.config = config

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def half(self) -> "PoseConditionalTask":
        """A bfloat16 copy of this task (``cast_half`` of both modules)."""
        return PoseConditionalTask(cast_half(self.unet), cast_half(self.vae), self.config)

    @torch.no_grad()
    def encode(self, images: torch.Tensor, mode: str = "mode") -> torch.Tensor:
        """VAE encode (frozen encoder): (B, H, W, 3) → (B, h, w, C)."""
        return self.vae.encode_image(images, mode)

    @torch.no_grad()
    def predict_latent(self, ref_latent: torch.Tensor, relativeR: torch.Tensor) -> torch.Tensor:
        """U-Net: (reference latent (B,h,w,C), ΔR (B, pose_dim)) → (B,h,w,C)."""
        out = self.unet(ref_latent.permute(0, 3, 1, 2), relativeR)
        return out.permute(0, 2, 3, 1).contiguous()

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
