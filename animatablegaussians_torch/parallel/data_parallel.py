"""Data parallelism over (pose, view) items: one process a device, one item
a rank, the gradients mean-reduced over the process group.

Port of ``animatablegaussians_tpu/parallel/data_parallel.py``. The JAX
package runs one SPMD program over a device mesh (``shard_map``) and
``pmean``s the gradients and the loss terms inside the step
(avatar_trainer.py:362-364,402-404); here each rank is a process of a
``torch.distributed`` group:

  * the parameters start replicated: rank 0 broadcasts them
    (``broadcast_params``);
  * each rank runs the single-item step's ``loss_and_grads`` on its own
    item and draws, then the gradients (one flat buffer, one all-reduce)
    and the loss terms are averaged over the group, and every rank applies
    the same Adam update;
  * the module is the rank's own ``AvatarNet``, never wrapped, so the
    parameter names and the checkpoint layout are the single process's.

With one item a rank the update is the mean gradient of a global batch of
``world_size`` items, as the JAX mesh's. The backend follows the device
the caller names: ``nccl`` for CUDA, ``gloo`` for the CPU; a group of the
other backend is refused, never used as a fallback.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from animatablegaussians_torch.training import avatar_trainer as at
from animatablegaussians_torch.utils.device import resolve

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# how long a collective waits for the other ranks: rank 0's pretrain phase
# (5,000 iterations) runs while the others wait at a barrier
GROUP_TIMEOUT = datetime.timedelta(hours=2)


def backend_for(device) -> str:
    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"data parallel: no backend for device {dev}")
    return BACKENDS[dev.type]


def init_group(device, rank: int, world_size: int,
               init_method: str = "env://") -> torch.device:
    """Bring up the default process group with ``device``'s backend
    (collectives wait ``GROUP_TIMEOUT``); a CUDA ``device`` becomes the
    current one. Returns ``device``."""
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=GROUP_TIMEOUT)
    return dev


def init_from_env(device, init_method: Optional[str] = None):
    """The group torchrun describes (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``; ``init_method`` default ``env://``, torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``): returns the rank's device, the card
    ``cuda:LOCAL_RANK`` or the CPU, as ``device`` says; None, and no group,
    when ``WORLD_SIZE`` is not set."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world_size = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return init_group(dev, rank, world_size, init_method or "env://")


def world():
    """(rank, world size); (0, 1) without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _check_backend(net) -> None:
    want = backend_for(next(net.parameters()).device)
    got = dist.get_backend()
    if got != want:
        raise ValueError(f"data parallel: the net lives on "
                         f"{next(net.parameters()).device}, which needs a "
                         f"{want} group, not {got}")


@torch.no_grad()
def broadcast_params(net) -> None:
    """Every parameter and buffer of ``net`` takes rank 0's values."""
    for t in net.state_dict().values():
        dist.broadcast(t, 0)


def _all_reduce_mean(flat: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(flat)
    return flat.div_(dist.get_world_size())


@torch.no_grad()
def reduce_gradients(net) -> int:
    """Mean of every ``.grad`` of ``net`` over the ranks, in place, as one
    all-reduce of one flat buffer; returns its bytes. Parameters without a
    gradient (unreached by the loss, on every rank alike) are left out, as
    Adam leaves them."""
    grads = [p.grad for p in net.parameters() if p.grad is not None]
    flat = _all_reduce_mean(_flatten_dense_tensors(grads))
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)
    return flat.numel() * flat.element_size()


def _reduce_terms(terms: dict) -> dict:
    keys = list(terms)      # the same order on every rank: one code path
    flat = _all_reduce_mean(torch.stack([terms[k] for k in keys]))
    return dict(zip(keys, flat.unbind()))


def make_dp_train_step(step_fn):
    """``dp_step(state, items, draws) -> (state, terms)`` from a
    single-item step (``avatar_trainer.make_train_step``): this rank's
    ``items`` and ``draws`` through ``step_fn.loss_and_grads``, the
    gradients and the loss terms mean-reduced over the ranks, then the
    Adam update. ``dp_step.loss_and_grads`` stops before the update."""

    def loss_and_grads(state: at.TrainState, items: dict,
                       draws: dict) -> dict:
        _check_backend(state.net)
        terms = step_fn.loss_and_grads(state, items, draws)
        reduce_gradients(state.net)
        return _reduce_terms(terms)

    def dp_step(state: at.TrainState, items: dict, draws: dict):
        terms = loss_and_grads(state, items, draws)
        at.apply_update(state)
        return state, terms

    dp_step.loss_and_grads = loss_and_grads
    return dp_step


def make_dp_train_scan(step_fn):
    """``dp_scan(state, batch, draws_seq) -> (state, terms)``: one
    ``make_dp_train_step`` step for each of this rank's ``len(draws_seq)``
    items (every ``batch`` leaf has that leading axis), terms stacked, as
    ``make_train_scan_batched``; the counterpart of the JAX scan inside
    the ``shard_map`` body."""
    return at.make_train_scan_batched(make_dp_train_step(step_fn))
