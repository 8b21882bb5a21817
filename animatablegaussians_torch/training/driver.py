"""AvatarTrainer: config -> dataset -> pretrain -> epochs of train steps on
one card, or data parallel over the ranks of a process group.

Port of ``animatablegaussians_tpu/training/driver.py`` (ref:
main_avatar.py:37-523) with the same class constants and config keys:

  * the pretrain phase regresses the position and other heads onto the
    canonical Gaussians from pose-map-only items, then saves
    ``pretrained/``;
  * the main loop reads batches through ``data.loader.PrefetchLoader`` and
    takes ``make_train_step`` steps (``make_train_scan_batched`` over
    ``train.scan_steps`` items at a time when > 1), Adam on a cosine
    schedule over ``ITER_NUM``;
  * smoothed losses go to stdout and ``loss.txt`` every ``log_interval``
    steps, and to TensorBoard when ``torch.utils.tensorboard`` imports;
  * ``config_bk.yaml``, a mini-test snapshot every ``eval_interval``
    steps, rotating ``batch_%d`` checkpoints every ``ckpt_interval.batch``
    steps and ``epoch_latest`` after every epoch;
  * ``model.module`` names the module whose ``AvatarNet`` is built, with
    the port's constructor contract (JAX driver.py:164-170); a name under
    ``animatablegaussians_tpu.`` means the port's module at the same path.

Under a ``torch.distributed`` group of more than one rank the driver
trains data parallel (``use_dp``, JAX driver.py:97-140,282-325): every
rank shuffles alike and takes its own block of each global batch of
``world_size * scan_steps`` items, draws from a generator seeded with
``SEED + rank``, and runs ``parallel.make_dp_train_step`` (or its scan),
which averages the gradients over the ranks. Rank 0 alone runs the
pretrain phase, while the others wait, and writes the logs, snapshots and
checkpoints; every rank loads a checkpoint it resumes from. A dataset
smaller than the group is refused: the JAX driver falls back to one
device there, which for processes would train one copy a rank.

The JAX driver's binning-cap autosize pass and overflow healing have no
counterpart: the port's binning is sized per frame from the exact pair
count and never drops a pair.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import statistics
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import yaml

from animatablegaussians_torch.data import get_dataset_class, image_io
from animatablegaussians_torch.data.loader import PrefetchLoader
from animatablegaussians_torch.parallel import data_parallel as dp
from animatablegaussians_torch.tools.render_fixture import (RENDER_KEYS,
                                                            TRAIN_KEYS)
from animatablegaussians_torch.training import avatar_trainer as at
from animatablegaussians_torch.training import checkpoint as ck
from animatablegaussians_torch.training.lpips import (LPIPS,
                                                      resolve_lpips_params)
from animatablegaussians_torch.utils import exr

SEED = 31359               # ref: main_avatar.py:817-818
# model.module: the default, and the JAX package's prefix, which names the
# port's module at the same path
AVATAR_MODULE = "animatablegaussians_torch.models.avatar"
JAX_PREFIX = "animatablegaussians_tpu."
PORT_PREFIX = "animatablegaussians_torch."


def avatar_module(name: str) -> str:
    """The port's module for a ``model.module`` name."""
    if name.startswith(JAX_PREFIX):
        return PORT_PREFIX + name[len(JAX_PREFIX):]
    return name


class AvatarTrainer:
    PATCH_SIZE = 512
    ITER_NUM = 800_000       # ref: main_avatar.py:42
    PRETRAIN_ITERS = 5_000   # ref: main_avatar.py:321-326
    log_interval = 10

    def __init__(self, opt: dict, lpips_params: Optional[dict] = None,
                 device="cuda"):
        """``opt``: the config as a dict. ``lpips_params``: LPIPS weights
        (default: ``resolve_lpips_params(opt)``). Everything lives on
        ``device``, the rank's own under a process group."""
        self.opt = opt
        self.device = torch.device(device)
        self.rank, self.world_size = dp.world()
        train = opt["train"]
        self.lr_init = float(train.get("lr_init", 5e-4))
        self.loss_weight = train["loss_weight"]
        self.finetune_color = train.get("finetune_color", False)
        self.random_bg_color = train.get("random_bg_color", True)
        self.net_ckpt_dir = train.get("net_ckpt_dir", "./results")
        self.ckpt_interval = train.get("ckpt_interval",
                                       dict(epoch=10, batch=50_000))
        self.eval_interval = train.get("eval_interval", 1000)
        if lpips_params is None:
            lpips_params = resolve_lpips_params(opt)
        self.lpips = (None if lpips_params is None
                      else LPIPS(lpips_params, device=self.device))
        self.iter_idx = 0
        self.epoch_idx = 0
        print(f"# JPEG codec: {image_io.CODEC}")

        t0 = time.perf_counter()
        ds_cls = get_dataset_class(train.get("dataset",
                                             "MvRgbDatasetAvatarReX"))
        self.dataset = ds_cls(**train["data"])
        self.dataset_init_s = time.perf_counter() - t0

        self.avatar_net = self._build_net(train["data"]["data_dir"],
                                          opt.get("model", {}), self.device)
        cam = self.dataset.used_cam_ids[0]
        self.img_w = int(self.dataset.img_widths[cam])
        self.img_h = int(self.dataset.img_heights[cam])
        self.state = at.make_train_state(self.avatar_net, self.lr_init,
                                         self.ITER_NUM, self.finetune_color)
        n_params = sum(p.numel() for p in self.avatar_net.parameters())
        print(f"# Parameter number of AvatarNet is {n_params}")

        self.scan_steps = int(train.get("scan_steps", 1))
        n_items = len(self.dataset)
        self.use_dp = self.world_size > 1
        if self.use_dp and n_items < self.world_size:
            raise ValueError(f"data parallel over {self.world_size} ranks "
                             f"needs at least one item a rank; the dataset "
                             f"has {n_items}")
        if self.use_dp and self.scan_steps > n_items // self.world_size:
            # a call needs world_size * scan_steps items (JAX driver.py:120)
            print(f"# scan_steps {self.scan_steps} -> "
                  f"{n_items // self.world_size} (dataset of {n_items} "
                  f"items over {self.world_size} ranks)")
            self.scan_steps = n_items // self.world_size
        step = at.make_train_step(
            self.avatar_net, loss_weight=self.loss_weight, lpips=self.lpips,
            random_bg_color=self.random_bg_color,
            patch_size=self.PATCH_SIZE, img_w=self.img_w, img_h=self.img_h)
        if self.use_dp:
            step = (dp.make_dp_train_scan(step) if self.scan_steps > 1
                    else dp.make_dp_train_step(step))
            print(f"# data parallel over {self.world_size} ranks "
                  f"({dist.get_backend()}), rank {self.rank}")
        elif self.scan_steps > 1:
            step = at.make_train_scan_batched(step)
        if self.scan_steps > 1:
            print(f"# {self.scan_steps} steps a call")
        self.train_step = step
        self.pretrain_step = at.make_pretrain_step(self.avatar_net)
        self.generator = torch.Generator(device=self.device).manual_seed(
            SEED + self.rank)
        # of the last epoch: each iteration's loss terms and wall ms (loader
        # wait, step, logging, snapshots, checkpoints), and the loader's
        # waits
        self.terms: list = []
        self.iter_ms: list = []
        self.loader_waits: list = []

    @staticmethod
    def _build_net(data_dir: str, model_opt: dict, device):
        """The ``AvatarNet`` of ``model.module`` (default ``AVATAR_MODULE``)
        from the subject's canonical maps (ref: network/avatar.py:26-32,
        main_avatar.py:45-47)."""
        net_cls = importlib.import_module(avatar_module(
            model_opt.get("module", AVATAR_MODULE))).AvatarNet
        pm = os.path.join(data_dir, "smpl_pos_map")
        cano_map = exr.read_exr(os.path.join(pm, "cano_smpl_pos_map.exr"))
        lbs = np.load(os.path.join(pm, "init_pts_lbs.npy"))
        nml = None
        if model_opt.get("with_viewdirs", True):
            nml = exr.read_exr(os.path.join(pm, "cano_smpl_nml_map.exr"))
        return net_cls(model_opt, cano_map, lbs, cano_nml_map=nml,
                       device=device, seed=SEED)

    def _to_device(self, item: dict, keys) -> dict:
        return {k: torch.as_tensor(item[k], device=self.device)
                for k in keys}

    def pretrain(self):
        """Pose-map-only items through the pretrain step with its own Adam,
        then ``pretrained/`` (ref: main_avatar.py:266-326). Under data
        parallelism rank 0 alone runs it while the other ranks wait at a
        barrier; ``train`` then gives them its parameters."""
        if self.rank == 0:
            self._pretrain()
        if self.use_dp:
            dist.barrier()

    def _pretrain(self):
        state = at.make_train_state(self.avatar_net, 5e-4,
                                    self.PRETRAIN_ITERS)
        n = len(self.dataset)
        for it in range(self.PRETRAIN_ITERS):
            item = self.dataset.getitem(it % n, training=True,
                                        skip_images=True)
            pose_map = torch.as_tensor(item["smpl_pos_map"][..., :3],
                                       device=self.device)
            state, losses = self.pretrain_step(state, pose_map)
            if it % 100 == 0:
                print(f"Pretrain iter {it}: " + ", ".join(
                    f"{k}: {float(v):.4f}" for k, v in losses.items()))
        ck.save_checkpoint(os.path.join(self.net_ckpt_dir, "pretrained"),
                           self.avatar_net)

    def _step(self, batch: dict) -> dict:
        """One train call on a loader batch (``scan_steps`` items); returns
        the last step's loss terms as floats."""
        net = self.avatar_net
        draws = [at.make_draws(self.generator, net.n_points,
                               at.draws_style_dim(net))
                 for _ in range(self.scan_steps)]
        if self.scan_steps > 1:
            self.state, terms = self.train_step(self.state, batch, draws)
            terms = {k: v[-1] for k, v in terms.items()}
        else:
            self.state, terms = self.train_step(
                self.state, {k: v[0] for k, v in batch.items()}, draws[0])
        self.iter_idx = self.state.iter_idx
        return {k: float(v) for k, v in terms.items()}

    def _open_outputs(self):
        """Rank 0's ``config_bk.yaml``, TensorBoard writer (or None) and
        ``loss.txt``."""
        os.makedirs(self.net_ckpt_dir, exist_ok=True)
        with open(os.path.join(self.net_ckpt_dir, "config_bk.yaml"),
                  "w") as fp:
            yaml.dump(self.opt, fp)
        log_dir = os.path.join(self.net_ckpt_dir,
                               datetime.now().strftime("%Y_%m_%d_%H_%M_%S"))
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(log_dir)
            print(f"# TensorBoard: on, {log_dir}")
        except Exception as exc:
            writer = None
            print(f"# TensorBoard: off ({type(exc).__name__}: {exc})")
        return writer, open(os.path.join(self.net_ckpt_dir, "loss.txt"), "a")

    def train(self, num_epochs: int = 10**9):
        """Epochs of train steps; under data parallelism every rank starts
        from rank 0's parameters (broadcast) and steps on its own items,
        and rank 0 alone logs, snapshots and checkpoints."""
        lead = self.rank == 0
        writer, loss_txt = (self._open_outputs() if lead
                            else (None, contextlib.nullcontext()))
        if self.use_dp:
            dp.broadcast_params(self.avatar_net)
        loader = PrefetchLoader(
            self.dataset, batch_size=self.scan_steps, shuffle=True,
            num_threads=self.opt["train"].get("num_workers", 8),
            device=self.device, select_keys=TRAIN_KEYS, rank=self.rank,
            world_size=self.world_size)
        smooth: dict = {}
        epochs = 0
        t0 = time.time()
        with loss_txt:
            while self.iter_idx < self.ITER_NUM and epochs < num_epochs:
                epochs += 1
                self.terms, self.iter_ms = [], []
                t_iter = time.perf_counter()
                for batch in loader:
                    self.terms.append(self._step(batch))
                    # with scans the counter moves scan_steps a call: fire
                    # when a multiple of the interval was crossed in it
                    if lead and (self.iter_idx % self.log_interval
                                 < self.scan_steps):
                        for k, v in self.terms[-1].items():
                            smooth[k] = smooth.get(k, v) * 0.9 + v * 0.1
                            if writer:
                                writer.add_scalar(f"losses/{k}", smooth[k],
                                                  self.iter_idx)
                        msg = (f"Iter {self.iter_idx} "
                               f"({time.time() - t0:.1f}s): " + ", ".join(
                                   f"{k}: {v:.4f}" for k, v in smooth.items()))
                        print(msg)
                        loss_txt.write(msg + "\n")
                        loss_txt.flush()
                    if lead and (self.iter_idx % self.eval_interval
                                 < self.scan_steps):
                        self.mini_test()
                    if lead and (self.iter_idx % self.ckpt_interval["batch"]
                                 < self.scan_steps):
                        self.save_ckpt(os.path.join(
                            self.net_ckpt_dir, f"batch_{self.iter_idx}"))
                        ck.rotate_checkpoints(self.net_ckpt_dir)
                    now = time.perf_counter()
                    self.iter_ms.append((now - t_iter) * 1e3)
                    t_iter = now
                self.loader_waits = loader.waits
                self.epoch_idx += 1
                if lead:
                    self.save_ckpt(os.path.join(self.net_ckpt_dir,
                                                "epoch_latest"))
        if writer:
            writer.close()
        if self.iter_ms:
            print(f"# {len(self.iter_ms)} iterations: median "
                  f"{statistics.median(self.iter_ms):.2f} ms, loader wait "
                  f"mean {1e3 * statistics.mean(self.loader_waits):.2f} ms")

    @torch.no_grad()
    def mini_test(self):
        """One fixed training pose and view, and one testing pose and view,
        rendered on a white background beside the ground truth to
        ``eval/<tag>_<iter>.jpg`` (ref: main_avatar.py:444-523; ids are
        eval_training_ids / eval_testing_ids as (pose_idx, view_idx))."""
        out_dir = os.path.join(self.net_ckpt_dir, "eval")
        os.makedirs(out_dir, exist_ok=True)
        specs = [("training",
                  self.opt["train"].get("eval_training_ids", [0, 0])),
                 ("testing", self.opt["train"].get("eval_testing_ids"))]
        for tag, ids in specs:
            if ids is None:
                continue
            pose_idx, view_idx = (int(ids[0]), int(ids[1])) \
                if len(ids) > 1 else (int(ids[0]), 0)
            try:
                item = self.dataset.getitem(0, training=True,
                                            pose_idx=pose_idx,
                                            view_idx=view_idx, eval=True)
            except FileNotFoundError:
                continue  # frame missing on disk; anything else raises
            out = self.avatar_net.render(
                self._to_device(item, RENDER_KEYS), bg_color=(1.0, 1.0, 1.0),
                img_w=self.img_w, img_h=self.img_h)
            rgb = out["rgb_map"].clamp(0, 1).cpu().numpy()
            side = np.concatenate([rgb, item["color_img"]], axis=1)
            image_io.write_jpeg(os.path.join(
                out_dir, f"{tag}_{self.iter_idx}.jpg"),
                (side * 255).astype(np.uint8))

    def save_ckpt(self, path: str):
        ck.save_checkpoint(path, self.avatar_net, self.state.optimizer,
                           self.state.scheduler, epoch_idx=self.epoch_idx,
                           iter_idx=self.iter_idx)

    def load_ckpt(self, path: str, load_optm: bool = True):
        """Restore the weights (and with ``load_optm`` Adam, the schedule
        and the step count) from a checkpoint directory; a missing
        ``net.pt`` raises, so a mistyped pretrained path cannot train from
        the random init (ref: main_avatar.py:346-366)."""
        net_pt = os.path.join(path, "net.pt")
        if not os.path.exists(net_pt):
            raise FileNotFoundError(f"checkpoint not found: {net_pt}")
        if load_optm:
            meta = ck.load_checkpoint(path, self.avatar_net,
                                      self.state.optimizer,
                                      self.state.scheduler)
            self.state.iter_idx = meta["iter_idx"]
        else:
            meta = ck.load_checkpoint(path, self.avatar_net)
        self.iter_idx = meta["iter_idx"]
        self.epoch_idx = meta["epoch_idx"]
