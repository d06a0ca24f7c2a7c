"""Diagonal Gaussian latent distribution (``nope_tpu/models/distributions.py``).

Channel-last: parameters are (B, H, W, 2C), split into mean and logvar
along the trailing axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_parameters(cls, parameters: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(parameters, 2, dim=-1)
        return cls(mean=mean, logvar=torch.clamp(logvar, -30.0, 20.0))

    def mode(self) -> torch.Tensor:
        return self.mean
