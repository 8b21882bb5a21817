"""SDF -> density transforms (VolSDF family), a port of
``animatablegaussians_tpu/models/density.py`` (ref:
network/density.py:22-53): ``LaplaceDensity`` = alpha Laplace(0,
beta).cdf(-sdf) with a learnable beta; ``AbsDensity`` and
``SimpleDensity`` are the NeRF++ and NeRF variants."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class LaplaceDensity(nn.Module):
    """density = (1/beta) (0.5 + 0.5 sign(sdf) expm1(-|sdf| / beta))
    (ref: network/density.py:22-35). ``torch.sign(0)`` is 0, as
    ``jnp.sign``."""

    def __init__(self, beta_init: float = 0.01, beta_min: float = 1e-4,
                 device="cuda"):
        super().__init__()
        self.beta_min = float(beta_min)
        self.beta = nn.Parameter(torch.tensor(float(beta_init),
                                              device=device))

    def get_beta(self) -> torch.Tensor:
        return torch.abs(self.beta) + self.beta_min

    def forward(self, sdf: torch.Tensor, beta=None) -> torch.Tensor:
        if beta is None:
            beta = self.get_beta()
        alpha = 1.0 / beta
        return alpha * (0.5 + 0.5 * torch.sign(sdf)
                        * torch.expm1(-torch.abs(sdf) / beta))


class AbsDensity(nn.Module):
    """NeRF++-style |sdf| (ref: network/density.py:38-40)."""

    def forward(self, sdf: torch.Tensor, beta=None) -> torch.Tensor:
        return torch.abs(sdf)


class SimpleDensity(nn.Module):
    """relu(sdf) with optional training noise drawn from ``generator``
    (ref: network/density.py:43-53)."""

    def __init__(self, noise_std: float = 1.0):
        super().__init__()
        self.noise_std = noise_std

    def forward(self, sdf: torch.Tensor, beta=None,
                generator: Optional[torch.Generator] = None):
        if generator is not None and self.noise_std > 0:
            sdf = sdf + self.noise_std * torch.randn(
                sdf.shape, generator=generator, device=sdf.device)
        return torch.relu(sdf)
