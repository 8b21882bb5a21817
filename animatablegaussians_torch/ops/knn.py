"""Brute-force k-nearest-neighbour search, chunked over queries.

Port of ``animatablegaussians_tpu/ops/knn.py:19-50``. Squared distances use
the same ``|q|^2 + |r|^2 - 2 q.r`` expansion in float32, so the scales that
``create_from_pcd`` derives from them track the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def knn(query: torch.Tensor, ref: torch.Tensor, k: int = 4,
        chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) queries, (M, D) refs -> (Q, k) squared distances (ascending,
    clamped at 0) and (Q, k) int32 indices. Each chunk holds a
    (chunk, M) distance block, so memory is bounded by ``chunk * M``."""
    ref_sq = torch.sum(ref * ref, dim=1)
    d2s, idxs = [], []
    for q in torch.split(query, chunk):
        d2 = (torch.sum(q * q, dim=1, keepdim=True) + ref_sq[None, :]
              - 2.0 * (q @ ref.T))
        d, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        d2s.append(d)
        idxs.append(i)
    d2 = torch.cat(d2s)
    return torch.clamp(d2, min=0.0), torch.cat(idxs).to(torch.int32)


def knn_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Features of the KNN indices: (M, C), (Q, k) -> (Q, k, C)
    (ref: utils/knn.py:4-15)."""
    return x[idx.long()]
