"""Generic training loop: dataset iteration, logging, checkpoint cadence.

Port of ``animatablegaussians_tpu/training/base_trainer.py`` (ref:
base_trainer.py:22-258). The caller's ``step_fn(items, generator) ->
loss terms`` owns the net's forward, backward and optimizer step; this
class keeps the JAX package's host orchestration: epochs over a shuffled
``PrefetchLoader``, TensorBoard (when ``torch.utils.tensorboard`` imports)
and ``loss.txt`` scalars with a 0.9 running mean every ``log_interval``
iterations, ``mini_test_fn(self)`` every ``eval_interval``, the
``batch_N`` checkpoints every ``ckpt_interval["batch"]`` iterations (the
older ones rotated away), ``epoch_N`` every ``ckpt_interval["epoch"]``
epochs and ``epoch_latest`` after each, and resume. Checkpoints are the
port's (``training/checkpoint.py``): ``net.pt`` with the epoch and
iteration, and ``optm.pt`` when the trainer has an optimizer.
"""

from __future__ import annotations

import os
import time
from datetime import datetime
from typing import Callable, Optional

import torch
import yaml

from animatablegaussians_torch.training import checkpoint as ck


class BaseTrainer:
    def __init__(self, opt: dict, step_fn: Callable, net: torch.nn.Module,
                 dataset, optimizer=None, scheduler=None,
                 items_fn: Optional[Callable] = None,
                 mini_test_fn: Optional[Callable] = None,
                 seed: int = 31359, device="cuda"):
        self.opt = opt
        self.step_fn = step_fn
        self.net = net
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.dataset = dataset
        self.items_fn = items_fn or (lambda item: item)
        self.mini_test_fn = mini_test_fn
        self.loss_weight = opt["train"]["loss_weight"]
        self.net_ckpt_dir = opt["train"].get("net_ckpt_dir", "./results")
        self.ckpt_interval = opt["train"].get(
            "ckpt_interval", dict(epoch=10, batch=50_000))
        self.eval_interval = opt["train"].get("eval_interval", 1000)
        self.log_interval = 10
        self.iter_idx = 0
        self.epoch_idx = 0
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # -- checkpoint plumbing (ref: base_trainer.py:38-71) -----------------
    def save_ckpt(self, path: str):
        ck.save_checkpoint(path, self.net, self.optimizer, self.scheduler,
                           epoch_idx=self.epoch_idx, iter_idx=self.iter_idx)

    def load_ckpt(self, path: str) -> int:
        """Restore the net (and the optimizer and schedule, where the
        trainer has them) and the counters; returns the epoch."""
        meta = ck.load_checkpoint(path, self.net, self.optimizer,
                                  self.scheduler)
        self.iter_idx = meta["iter_idx"]
        self.epoch_idx = meta["epoch_idx"]
        return self.epoch_idx

    # -- main loop (ref: base_trainer.py:131-247) --------------------------
    def train(self, iter_num: int = 10**9, num_epochs: int = 10**9,
              batch_size: int = 1, num_threads: int = 8):
        from animatablegaussians_torch.data.loader import PrefetchLoader

        os.makedirs(self.net_ckpt_dir, exist_ok=True)
        with open(os.path.join(self.net_ckpt_dir, "config_bk.yaml"),
                  "w") as fp:
            yaml.dump(self.opt, fp)
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(os.path.join(
                self.net_ckpt_dir,
                datetime.now().strftime("%Y_%m_%d_%H_%M_%S")))
        except Exception:
            writer = None
        loss_txt = open(os.path.join(self.net_ckpt_dir, "loss.txt"), "a")

        loader = PrefetchLoader(self.dataset, batch_size=batch_size,
                                shuffle=True, num_threads=num_threads,
                                device=self.device)
        smooth: dict = {}
        t0 = time.time()
        try:
            while self.iter_idx < iter_num and self.epoch_idx < num_epochs:
                self.epoch_idx += 1
                for batch in loader:
                    item = ({k: v[0] for k, v in batch.items()}
                            if batch_size == 1 else batch)
                    terms = self.step_fn(self.items_fn(item),
                                         self.generator)
                    self.iter_idx += 1

                    if self.iter_idx % self.log_interval == 0:
                        terms = {k: float(v) for k, v in terms.items()}
                        for k, v in terms.items():
                            smooth[k] = smooth.get(k, v) * 0.9 + v * 0.1
                            if writer:
                                writer.add_scalar(f"losses/{k}", smooth[k],
                                                  self.iter_idx)
                        msg = (f"Epoch {self.epoch_idx} iter {self.iter_idx} "
                               f"({time.time() - t0:.1f}s): "
                               + ", ".join(f"{k}: {v:.4f}"
                                           for k, v in smooth.items()))
                        print(msg)
                        loss_txt.write(msg + "\n")
                        loss_txt.flush()

                    if (self.mini_test_fn is not None
                            and self.iter_idx % self.eval_interval == 0):
                        self.mini_test_fn(self)
                    if self.iter_idx % self.ckpt_interval["batch"] == 0:
                        self.save_ckpt(os.path.join(
                            self.net_ckpt_dir, f"batch_{self.iter_idx}"))
                        ck.rotate_checkpoints(self.net_ckpt_dir)
                    if self.iter_idx >= iter_num:
                        break
                if self.epoch_idx % self.ckpt_interval.get("epoch", 10) == 0:
                    self.save_ckpt(os.path.join(self.net_ckpt_dir,
                                                f"epoch_{self.epoch_idx}"))
                self.save_ckpt(os.path.join(self.net_ckpt_dir,
                                            "epoch_latest"))
        finally:
            loss_txt.close()
            if writer:
                writer.close()
