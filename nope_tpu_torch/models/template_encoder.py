"""Template feature extractor (ResNet-50 + 1x1 projector) and its
contrastive losses (``nope_tpu/models/template_encoder.py``).

NCHW modules with the reference's state-dict names (``backbone.*``,
``projector.{1,3}``; the tiny extractor's ``encoder.{0,2,4.0,4.2}``),
which ``nope_tpu.training.port.port_template_encoder`` and
``port_base_feature_extractor`` map.  Both extractors take the VAE's
place in the task: ``encode_image(images, mode)`` maps NHWC images in
[-1, 1] to NHWC features (``mode`` is ignored: features are
deterministic) and ``latent_dim`` is their channel count.  Neither has
a decoder, so the task makes no RGB previews for them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nope_tpu_torch.models.resnet import resnet50


class TemplateFeatureExtractor(nn.Module):
    """A fully-convolutional ResNet-50 (f8) → ReLU → 1x1 conv to 256 →
    ReLU → 1x1 conv to ``descriptor_size``; ``normalize`` L2-normalises
    each pixel's descriptor."""

    def __init__(self, descriptor_size: int = 8, normalize: bool = False):
        super().__init__()
        self.descriptor_size, self.normalize = descriptor_size, normalize
        self.backbone = resnet50(use_avg_pooling_and_fc=False)
        self.projector = nn.Sequential(
            nn.ReLU(), nn.Conv2d(self.backbone.out_channels, 256, 1, bias=False),
            nn.ReLU(), nn.Conv2d(256, descriptor_size, 1, bias=False))

    @property
    def latent_dim(self) -> int:
        return self.descriptor_size

    def encode_image(self, image: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
        """(B, H, W, 3) → (B, H/8, W/8, descriptor_size)."""
        x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feat = self.projector(self.backbone(x)).permute(0, 2, 3, 1)
        if self.normalize:
            feat = feat / torch.linalg.norm(feat, dim=-1, keepdim=True).clamp(min=1e-12)
        return feat.contiguous()

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.encode_image(image)


class BaseFeatureExtractor(nn.Module):
    """The tiny conv encoder: 8x8/2 conv → ReLU → 5x5 conv → ReLU → 1x1
    projector (7 → 256 → ``descriptor_size``), all unpadded, so the
    feature map's side is odd ((32 - 8) / 2 + 1 - 4 = 9 for 32 px): a
    retrieval encoder alone, not a U-Net input."""

    def __init__(self, descriptor_size: int = 8):
        super().__init__()
        self.descriptor_size = descriptor_size
        self.encoder = nn.Sequential(
            nn.Conv2d(3, 16, 8, stride=2), nn.ReLU(), nn.Conv2d(16, 7, 5), nn.ReLU(),
            nn.Sequential(nn.Conv2d(7, 256, 1, bias=False), nn.ReLU(), nn.Conv2d(256, descriptor_size, 1, bias=False)))

    @property
    def latent_dim(self) -> int:
        return self.descriptor_size

    def encode_image(self, image: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
        x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.encoder(x).permute(0, 2, 3, 1).contiguous()

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.encode_image(image)


def info_nce_loss(
    pos_sim: torch.Tensor,
    neg_sim: torch.Tensor,
    tau: float = 0.1,
    sim_extra_obj: Optional[torch.Tensor] = None,
    extra_contrast_type: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """InfoNCE over a (B, B) similarity matrix with the positives on the
    diagonal: (mean positive, mean negative, loss).  ``sim_extra_obj``
    adds extra-object negatives: ``"BOP_ShapeNet"`` widens each row's
    negatives (logits (B, 2B)); ``"ShapeNet_ShapeNet"`` adds B anchor rows
    with the same positives (logits (2B, B))."""
    b = neg_sim.shape[0]
    eye = torch.eye(b, dtype=neg_sim.dtype, device=neg_sim.device)
    logits = (1 - eye) * neg_sim + eye * pos_sim
    labels = torch.arange(b, device=neg_sim.device)
    if sim_extra_obj is not None:
        sim_extra_obj = sim_extra_obj[:b]
        if extra_contrast_type == "BOP_ShapeNet":
            logits = torch.cat([logits, sim_extra_obj], dim=1)
        elif extra_contrast_type == "ShapeNet_ShapeNet":
            logits = torch.cat([logits, (1 - eye) * sim_extra_obj + eye * pos_sim], dim=0)
            labels = torch.cat([labels, labels])
        else:
            raise ValueError(f"unknown extra_contrast_type {extra_contrast_type!r}")
    log_probs = F.log_softmax(logits / tau, dim=-1)
    loss = -torch.mean(torch.gather(log_probs, 1, labels[:, None]))
    return torch.mean(pos_sim), torch.mean(neg_sim), loss


def occlusion_aware_similarity(similarity_matrix: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """Zero the local similarities at or below ``threshold``."""
    return torch.where(similarity_matrix <= threshold, torch.zeros_like(similarity_matrix), similarity_matrix)
