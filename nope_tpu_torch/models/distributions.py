"""Diagonal Gaussian latent distribution (``nope_tpu/models/distributions.py``).

Channel-last: parameters are (B, H, W, 2C), split into mean and logvar
along the trailing axis.  ``kl`` and ``nll`` sum over every non-batch
axis (the reference's ``normal_kl_loss.py:43-72``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_parameters(cls, parameters: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(parameters, 2, dim=-1)
        return cls(mean=mean, logvar=torch.clamp(logvar, -30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """mean + std · noise, the noise drawn from ``generator`` on its
        own device, then moved to the mean's."""
        noise = torch.randn(self.mean.shape, generator=generator, dtype=self.mean.dtype,
                            device=generator.device)
        return self.mean + self.std * noise.to(self.mean.device)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussian"] = None) -> torch.Tensor:
        """KL(self ‖ other), or against N(0, 1) when ``other`` is None: (B,)."""
        dims = tuple(range(1, self.mean.dim()))
        if other is None:
            return 0.5 * torch.sum(torch.square(self.mean) + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            torch.square(self.mean - other.mean) / other.var + self.var / other.var - 1.0
            - self.logvar + other.logvar,
            dim=dims,
        )

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, self.mean.dim()))
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar + torch.square(sample - self.mean) / self.var, dim=dims)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """Broadcasting KL between two Gaussians, elementwise."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + torch.square(mean1 - mean2) * torch.exp(-logvar2))
