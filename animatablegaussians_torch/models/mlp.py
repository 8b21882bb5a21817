"""MLPs of the template: ``MLPLinear`` and ``SdfMLP`` (geometric init,
softplus(beta = 100), weight norm). A port of
``animatablegaussians_tpu/models/mlp.py`` (ref: network/mlp.py:16-120,
195-241) as ``nn.Module``s.

A layer's weight is (out, in), PyTorch's layout (the JAX package's is
(in, out)). A weight-normed layer stores ``weight`` (v) and ``g`` and uses
``g * v / sqrt(sum(v^2) + 1e-12)`` with the sum over the inputs, as the
JAX package writes it (``torch.nn.utils.weight_norm`` has no 1e-12).
Initialisation draws from a ``torch.Generator`` with the JAX package's
distributions; ``utils/convert.template_params_from_jax`` carries a JAX
initialisation across.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """``nn.Softplus(beta)``: log(1 + exp(beta x)) / beta, linear where
    beta x > 20."""
    bx = beta * x
    return torch.where(bx > 20.0, x,
                       torch.log1p(torch.exp(torch.clamp(bx, max=20.0)))
                       / beta)


_ACTS = {
    "relu": torch.relu,
    "softplus100": lambda x: softplus_beta(x, 100.0),
    "softplus": nn.functional.softplus,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    None: lambda x: x,
}


class Linear(nn.Module):
    """y = x W^T + b, W = g v / ||v|| per output row when ``g`` exists."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor,
                 g: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        self.g = None if g is None else nn.Parameter(g)

    def effective_weight(self) -> torch.Tensor:
        if self.g is None:
            return self.weight
        v = self.weight
        norm = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True) + 1e-12)
        return self.g[:, None] * v / norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.effective_weight().T + self.bias


def _uniform_layer(gen, in_dim, out_dim) -> Linear:
    lim = 1.0 / math.sqrt(in_dim)
    w = (torch.rand((out_dim, in_dim), generator=gen) * 2 - 1) * lim
    b = (torch.rand((out_dim,), generator=gen) * 2 - 1) * lim
    return Linear(w, b)


class MLPLinear(nn.Module):
    """Dense MLP with input-skip layers (layer l in ``res_layers`` takes
    concat([x, input])) and a last activation (ref: network/mlp.py:87-120).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 inter_channels: Sequence[int],
                 res_layers: Sequence[int] = (), nlactv: str = "relu",
                 last_op: Optional[str] = None, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.res_layers = tuple(res_layers)
        self.act = _ACTS[nlactv]
        self.last = _ACTS[last_op]
        chans = [in_channels] + list(inter_channels) + [out_channels]
        self.layer_dims = [
            (chans[l] + (in_channels if l in self.res_layers else 0),
             chans[l + 1]) for l in range(len(chans) - 1)]
        gen = torch.Generator().manual_seed(seed)
        self.layers = nn.ModuleList(self._init_layers(gen))
        self.to(device)

    def _init_layers(self, gen):
        return [_uniform_layer(gen, i, o) for i, o in self.layer_dims]

    def forward(self, x: torch.Tensor, return_inter_layer=()):
        inp = x
        inters = []
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i in self.res_layers:
                x = torch.cat([x, inp], dim=-1)
            x = layer(x)
            x = self.act(x) if i < n - 1 else self.last(x)
            if i in return_inter_layer:
                inters.append(x)
        if return_inter_layer:
            return x, inters
        return x


class SdfMLP(MLPLinear):
    """SDF MLP: softplus(beta = 100), geometric initialisation (a sphere of
    radius ``bias``) and weight norm (ref: network/mlp.py:195-241)."""

    def __init__(self, in_channels, out_channels, inter_channels,
                 res_layers=(), nlactv: str = "softplus100",
                 geometric_init: bool = True, bias: float = 0.5,
                 weight_norm: bool = True, device="cuda", seed: int = 0):
        self.geometric_init = geometric_init
        self.bias_init = bias
        self.weight_norm = weight_norm
        super().__init__(in_channels, out_channels, inter_channels,
                         res_layers, nlactv, None, device, seed)

    def _init_layers(self, gen):
        layers = []
        n = len(self.layer_dims)
        for l, (in_dim, out_dim) in enumerate(self.layer_dims):
            if not self.geometric_init:
                layer = _uniform_layer(gen, in_dim, out_dim)
                w, b = layer.weight.data, layer.bias.data
            elif l == n - 1:
                w = (math.sqrt(math.pi) / math.sqrt(in_dim)
                     + 1e-4 * torch.randn((out_dim, in_dim), generator=gen))
                b = torch.full((out_dim,), -self.bias_init)
            else:
                std = math.sqrt(2) / math.sqrt(out_dim)
                if l == 0:
                    w = torch.zeros((out_dim, in_dim))
                    w[:, :3] = torch.randn((out_dim, 3), generator=gen) * std
                else:
                    w = torch.randn((out_dim, in_dim), generator=gen) * std
                    extra = self.in_channels - 3
                    if l in self.res_layers and extra > 0:
                        w[:, -extra:] = 0.0
                b = torch.zeros((out_dim,))
            g = (torch.sqrt(torch.sum(w * w, dim=1) + 1e-12)
                 if self.weight_norm else None)
            layers.append(Linear(w.float(), b.float(), g))
        return layers
