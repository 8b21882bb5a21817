"""NeRF positional encoding, a port of
``animatablegaussians_tpu/ops/embedder.py`` (ref: utils/embedder.py:38-50).

``get_embedder(multires, d) -> (fn, out_dim)`` with
``fn(x) = [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]`` along the
last axis, f_k = 2^k.
"""

from __future__ import annotations

import torch


def get_embedder(multires: int, input_dims: int = 3):
    out_dim = input_dims * (1 + 2 * multires)

    def embed(x: torch.Tensor) -> torch.Tensor:
        freqs = 2.0 ** torch.arange(multires, dtype=x.dtype,
                                    device=x.device)           # (L,)
        xb = x[..., None, :] * freqs[:, None]                   # (..., L, d)
        sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
        flat = sc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
        return torch.cat([x, flat], dim=-1)

    return embed, out_dim
