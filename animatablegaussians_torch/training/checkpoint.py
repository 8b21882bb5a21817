"""Checkpoints in the reference's own layout, directory rotation and the
resume precedence.

A checkpoint directory holds ``net.pt`` = ``{"epoch_idx", "iter_idx",
"avatar_net": state_dict}`` and, with the optimizer, ``optm.pt`` =
``{"avatar_net": Adam state_dict, "lr_scheduler": LambdaLR state_dict}``
(ref: main_avatar.py:778-793). The port's ``AvatarNet`` state dict uses the
reference's key names for the three heads and ``viewdir_net``; it adds the
canonical Gaussians (``cano_gaussian.*``), which the port trains. A
reference ``net.pt`` has none: loading it keeps the constructor's, as the
JAX package's ``import_avatar_params`` does (checkpoint.py:199-216). Any
other missing or unexpected key is refused. A save followed by a load
restores the weights, Adam's moments and step counts, the schedule and the
iteration bit for bit.

``rotate_checkpoints`` and ``resolve_resume_dir`` are copies of the JAX
package's (checkpoint.py:65-94).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

# state-dict keys a reference net.pt lacks, kept from the constructor
CONSTRUCTOR_KEYS = "cano_gaussian."


def save_checkpoint(ckpt_dir: str, net: torch.nn.Module, optimizer=None,
                    scheduler=None, *, epoch_idx: int = 0,
                    iter_idx: int = 0) -> None:
    """Write ``net.pt`` and, when ``optimizer`` is given, ``optm.pt`` (its
    ``lr_scheduler`` None without a ``scheduler``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save({"epoch_idx": int(epoch_idx), "iter_idx": int(iter_idx),
                "avatar_net": net.state_dict()},
               os.path.join(ckpt_dir, "net.pt"))
    if optimizer is not None:
        torch.save({"avatar_net": optimizer.state_dict(),
                    "lr_scheduler": (None if scheduler is None
                                     else scheduler.state_dict())},
                   os.path.join(ckpt_dir, "optm.pt"))


def load_net_state(net: torch.nn.Module, state_dict: dict) -> None:
    """Load ``state_dict`` into ``net``: missing ``cano_gaussian.*`` keys
    keep the constructor's values; any other missing or unexpected key
    raises ``KeyError``."""
    own = net.state_dict()
    missing = own.keys() - state_dict.keys()
    kept = {k for k in missing if k.startswith(CONSTRUCTOR_KEYS)}
    unexpected = state_dict.keys() - own.keys()
    if missing - kept or unexpected:
        raise KeyError(f"checkpoint does not match the net: missing "
                       f"{sorted(missing - kept)}, unexpected "
                       f"{sorted(unexpected)}")
    net.load_state_dict({**{k: own[k] for k in kept}, **state_dict})


def load_checkpoint(ckpt_dir: str, net: torch.nn.Module, optimizer=None,
                    scheduler=None) -> dict:
    """Restore ``net`` from ``net.pt`` (and ``optimizer`` and ``scheduler``
    from ``optm.pt`` when given). Returns ``{"epoch_idx", "iter_idx"}``
    (0 where the file has none)."""
    dev = next(net.parameters()).device
    ckpt = torch.load(os.path.join(ckpt_dir, "net.pt"), map_location=dev,
                      weights_only=True)
    load_net_state(net, ckpt["avatar_net"])
    if optimizer is not None:
        # on the CPU, as saved: load_state_dict moves the moments to their
        # parameters' device and leaves Adam's step counts on the CPU
        optm = torch.load(os.path.join(ckpt_dir, "optm.pt"),
                          map_location="cpu", weights_only=True)
        optimizer.load_state_dict(optm["avatar_net"])
        if scheduler is not None:
            scheduler.load_state_dict(optm["lr_scheduler"])
    return {k: int(ckpt.get(k, 0)) for k in ("epoch_idx", "iter_idx")}


def rotate_checkpoints(base_dir: str, keep_pattern: str = r"^batch_\d+$",
                       keep_latest: int = 1):
    """Delete old rotating ``batch_%d`` dirs, keeping the newest
    (ref: main_avatar.py:420-425)."""
    if not os.path.isdir(base_dir):
        return
    batches = []
    for d in os.listdir(base_dir):
        if re.match(keep_pattern, d):
            batches.append((int(d.split("_")[1]), d))
    for _, d in sorted(batches)[:-keep_latest]:
        shutil.rmtree(os.path.join(base_dir, d), ignore_errors=True)


def resolve_resume_dir(net_ckpt_dir: str, prev_ckpt: Optional[str] = None,
                       pretrained_dir: Optional[str] = None):
    """Resume precedence: explicit prev_ckpt -> epoch_latest (with optm) ->
    pretrained (weights only) -> None (ref: main_avatar.py:346-366).
    Returns (dir, load_optimizer)."""
    if prev_ckpt:
        return prev_ckpt, True
    latest = os.path.join(net_ckpt_dir, "epoch_latest")
    if os.path.exists(latest):
        return latest, True
    for cand in (pretrained_dir,
                 os.path.join(os.path.dirname(net_ckpt_dir), "pretrained")):
        if cand and os.path.exists(cand):
            return cand, False
    return None, False
