"""ResNet backbone of the template encoder (``nope_tpu/models/resnet.py``).

NCHW modules with torchvision's state-dict names (``conv1``, ``bn1``,
``layer{1..4}.{i}.*``, ``downsample.{0,1}``, ``fc``), which
``nope_tpu.training.port.port_template_encoder`` maps, with the
template-pose changes: ``use_avg_pooling_and_fc=False`` skips the stem's
max-pool and the head, and the stages' strides are (1, 2, 2, 1), so a
256-px image gives 32x32 features (f8, the VAE latent grid).

BatchNorm is frozen (the template encoder is never trained): the
statistics are buffers (``running_mean``, ``running_var``) and the affine
``weight`` and ``bias``; a torchvision ``num_batches_tracked`` entry is
accepted and dropped on load.  Plain PyTorch (cuDNN), as in JAX.
"""

from __future__ import annotations

from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm: (x - mean) · rsqrt(var + eps) · weight + bias."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def per_channel(t):
            return t[None, :, None, None]

        inv = torch.rsqrt(self.running_var + self.eps)
        out = (x - per_channel(self.running_mean)) * per_channel(inv)
        return out * per_channel(self.weight) + per_channel(self.bias)


def _downsample(inplanes: int, planes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False), FrozenBatchNorm(planes))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = _downsample(inplanes, planes * 4, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = _downsample(inplanes, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    """layers=(3, 4, 6, 3), block=Bottleneck is ResNet-50.  Input (B, 3, H, W)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), block: Type[nn.Module] = Bottleneck,
                 features: int = 64, use_avg_pooling_and_fc: bool = False, num_classes: int = 1000):
        super().__init__()
        self.use_avg_pooling_and_fc = use_avg_pooling_and_fc
        self.conv1 = nn.Conv2d(3, features, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        inplanes = features
        for li, (n_blocks, stride) in enumerate(zip(layers, (1, 2, 2, 1))):  # layer4 stride 1
            planes = features * 2**li
            blocks = []
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                blocks.append(block(inplanes, planes, s, s != 1 or inplanes != planes * block.expansion))
                inplanes = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.out_channels = inplanes
        self.fc = nn.Linear(inplanes, num_classes) if use_avg_pooling_and_fc else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        if self.use_avg_pooling_and_fc:
            out = F.max_pool2d(out, 3, stride=2, padding=1)
        for li in range(1, 5):
            out = getattr(self, f"layer{li}")(out)
        if self.use_avg_pooling_and_fc:
            out = self.fc(out.mean(dim=(2, 3)))
        return out


def resnet18(**kwargs) -> ResNet:
    return ResNet(layers=(2, 2, 2, 2), block=BasicBlock, **kwargs)


def resnet34(**kwargs) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), block=BasicBlock, **kwargs)


def resnet50(**kwargs) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), block=Bottleneck, **kwargs)


def resnet101(**kwargs) -> ResNet:
    return ResNet(layers=(3, 4, 23, 3), block=Bottleneck, **kwargs)


def resnet152(**kwargs) -> ResNet:
    return ResNet(layers=(3, 8, 36, 3), block=Bottleneck, **kwargs)
