"""Train cells: a closed loop of the program's train step, steps back to
back, each on the next B distinct frames of a pool staged on the card.

The pool is ``cameras`` ring cameras times ``poses`` poses of the seed,
each frame with its own seeded colour image, mask and boundary band; the
seed orders it. Each step draws its background colour and view-direction
jitter from the seed's generator on the card. A step ends in a host read
of its loss. The first ``check_steps`` steps are the warm-up; the plain
reference follows them from the same weights, frames and draws once the
window has closed.
"""

from __future__ import annotations

import math
import statistics
import sys

import torch

from .. import inputs
from ..reference import train as ref_train
from . import common


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t, c = ctx.traffic, ctx.cfg
        self.batch = int(t["batch"])
        self.img_w, self.img_h = int(c["camera"]["img_w"]), \
            int(c["camera"]["img_h"])
        self.tcfg = c["train"]
        self.frames_per_call = self.batch
        self.img_size = (self.img_w, self.img_h)
        self.fault = None
        self.last_frames = []
        self.ref_pairs = None

    # -- set-up ----------------------------------------------------------
    def setup(self):
        ctx, t = self.ctx, self.ctx.traffic
        dev = ctx.device
        with common.part(ctx, "imports"):
            from animatablegaussians_torch.training import avatar_trainer as at
            from animatablegaussians_torch.training.lpips import LPIPS
        self.net = common.program_avatar(ctx)
        self.n_points = self.net.n_points
        with common.part(ctx, "weights"):
            self.lpips = LPIPS(inputs.lpips_weights(ctx.seed, dev), device=dev)
        with common.part(ctx, "inputs"):
            self._make_pool()
        tc = self.tcfg
        with common.part(ctx, "optimizer"):
            self.state = at.make_train_state(self.net, float(tc["lr_init"]),
                                             int(tc["iter_num"]))
            kw = dict(loss_weight=tc["loss_weight"], lpips=self.lpips,
                      random_bg_color=bool(tc["random_bg_color"]),
                      patch_size=int(tc["patch_size"]),
                      random_patch_after=int(tc["random_patch_after"]),
                      img_w=self.img_w, img_h=self.img_h)
            self.step_fn = (at.make_train_step(self.net, **kw)
                            if self.batch == 1
                            else at.make_train_step_batched(self.net, **kw))
            self.gen = torch.Generator(device=dev).manual_seed(
                inputs.seed_of(ctx.seed, 5))
        self.k = 0
        with common.part(ctx, "warm-up"):
            self._check_steps(int(t["check_steps"]))

    def _make_pool(self):
        ctx, t, cam = self.ctx, self.ctx.traffic, self.ctx.cfg["camera"]
        n_cam, n_pose = int(t["cameras"]), int(t["poses"])
        poses = common.PosePool(ctx, n_pose)
        extr, intr = inputs.ring_cameras(n_cam, self.img_w, self.img_h,
                                         float(cam["train_dist"]),
                                         float(cam["train_focal"]))
        n = n_cam * n_pose
        color, mask, band = inputs.train_images(n, self.img_w, self.img_h,
                                                ctx.seed, ctx.device)
        dev = ctx.device
        self.pool = []
        for f in range(n):
            p, c = divmod(f, n_cam)
            self.pool.append(dict(
                smpl_pos_map=poses.maps[p], cano2live_jnt_mats=poses.mats[p],
                extr=torch.as_tensor(extr[c], device=dev),
                intr=torch.as_tensor(intr, device=dev),
                color_img=color[f], mask_img=mask[f],
                boundary_mask_img=band[f]))
        self.order = common.order(ctx, n, 6)
        if self.batch > n:
            raise ValueError("the pool holds fewer frames than a batch")

    # -- the timed call --------------------------------------------------
    def _next(self):
        """The next step's frames and draws."""
        n = len(self.order)
        self.last_frames = [self.order[(self.k * self.batch + j) % n]
                            for j in range(self.batch)]
        frames = [self.pool[f] for f in self.last_frames]
        draws = [dict(bg=torch.rand(3, generator=self.gen,
                                    device=self.ctx.device),
                      viewdir_noise=torch.randn(
                          (self.net.n_points, 3), generator=self.gen,
                          device=self.ctx.device),
                      crop=None) for _ in frames]
        self.k += 1
        return frames, draws

    def _step(self, frames, draws) -> float:
        if self.fault == "position_off" and not hasattr(self, "_hook"):
            # the position head's output dropped where it is produced
            self._hook = self.net.position_net.register_forward_hook(
                lambda mod, args, out: torch.zeros_like(out))
        if self.fault == "half_batch":
            frames, draws = frames[:len(frames) // 2], draws[:len(draws) // 2]
        if self.batch == 1:
            items, d = frames[0], draws[0]
        else:
            items = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
            d = draws
        if self.fault == "lpips_off":
            self.lpips.forward = lambda a, b, normalize=True: 0 * a.sum(
                (1, 2, 3))
        if self.fault == "no_update":
            terms = self.step_fn.loss_and_grads(self.state, items, d)
        else:
            _, terms = self.step_fn(self.state, items, d)
        return float(terms["total_loss"])

    def call(self):
        """One step: -> (frames trained, frames failed)."""
        frames, draws = self._next()
        loss = self._step(frames, draws)
        ok = math.isfinite(loss)
        return self.batch, 0 if ok else self.batch

    # -- the check ------------------------------------------------------
    def _check_steps(self, n: int):
        """The first n steps through ``call``'s path, recording what the
        reference follows: frames, draws, each loss, the first gradient's
        norm by leaf as Adam holds it, and each leaf's change after n."""
        params = dict(self.net.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        self.check_in = []
        self.prog = dict(loss=[])
        for i in range(n):
            frames, draws = self._next()
            self.check_in.append(([dict(f) for f in frames],
                                  [dict(bg=d["bg"].clone(),
                                        viewdir_noise=d["viewdir_noise"]
                                        .clone()) for d in draws]))
            self.prog["loss"].append(self._step(frames, draws))
            if i == 0:
                st = self.state.optimizer.state
                self.prog["grad"] = {
                    k: float(st[p]["exp_avg"].norm()) / (1 - 0.9)
                    for k, p in params.items() if p in st}
        self.prog["delta"] = {k: float((p.detach() - start[k]).norm())
                              for k, p in params.items()}
        del start

    def pair_counts(self):
        """The program's pair count of the first and the last frame it
        trained on, rendered without autograd after the window."""
        out = []
        n = len(self.order)
        for k in (0, (self.k * self.batch - 1) % n):
            it = self.pool[self.order[k]]
            out.append(int(self.net.render(it, img_w=self.img_w,
                                           img_h=self.img_h)["n_pairs"]))
        return out

    def check(self, traced: list) -> dict:
        """Frees the program and holds its check steps against the plain
        reference's; the reference also bins the ``traced`` frames."""
        first, last = self.pair_counts()
        print(f"pairs: first trained frame {first}, last {last} (the "
              f"program's binning, after the window)", file=sys.stderr)
        self.free_program()
        self.ref = self.reference(traced=traced)
        self.leaves = dict(program=self.prog, reference=self.ref)
        return self.compare(self.prog, self.ref)

    def control(self) -> dict:
        """The control's numbers: the reference in TF32 in the program's
        place, held against the reference in float32."""
        self.leaves["control"] = self.reference(tf32=True)
        return self.compare(self.leaves["control"], self.ref)

    def free_program(self):
        del self.net, self.state, self.step_fn, self.lpips
        torch.cuda.empty_cache() if self.ctx.device.type == "cuda" else None

    def reference(self, tf32: bool = False, traced=()) -> dict:
        """The plain reference's readings of the check steps; it bins the
        ``traced`` frames (pool indices) at the starting weights first."""
        ctx, tc = self.ctx, self.tcfg
        model = common.reference_avatar(ctx, tf32)
        if traced:
            self.ref_pairs = [model.pair_count(self.pool[f], self.img_w,
                                               self.img_h) for f in traced]
        lw = inputs.lpips_weights(ctx.seed, ctx.device)
        params = {k: p for k, p in model.named_parameters()}
        start = {k: p.detach().clone() for k, p in params.items()}
        opt = ref_train.Adam(params.values(), float(tc["lr_init"]),
                             int(tc["iter_num"]))
        lw_loss = {k: float(v) for k, v in tc["loss_weight"].items()}
        out = dict(loss=[])
        for i, (frames, draws) in enumerate(self.check_in):
            out["loss"].append(ref_train.step_loss_and_grads(
                model, frames, draws, lw, lw_loss, int(tc["patch_size"]),
                self.img_w, self.img_h))
            if i == 0:
                out["grad"] = {k: float(p.grad.norm())
                               for k, p in params.items()
                               if p.grad is not None}
            opt.step()
        out["delta"] = {k: float((p.detach() - start[k]).norm())
                        for k, p in params.items()}
        common.precision(ctx.cfg)
        return out

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        """The numbers compared: the first step's relative loss gap (the
        later steps' losses carry the round-off that Adam turns into whole
        steps of the scalar leaves; the change covers them), and by the
        worst leaf the gap between the two sides' norms of the first
        gradient and of the change after the check steps, each over the
        larger of the leaf's reference norm and the median leaf's. The
        gradient's gap takes every leaf; the change's leaves those whose
        first reference gradient is above a thousandth of the median
        leaf's, as Adam moves the others by round-off alone."""
        gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                    ref["loss"])]
        print("loss gaps by step: " + ", ".join(f"{g:.3g}" for g in gaps),
              file=sys.stderr)
        g_ref = ref["grad"]
        moved = [v for v in g_ref.values() if v > 0]
        med = statistics.median(moved) if moved else 0.0

        def worst(p: dict, r: dict, names, label: str) -> float:
            scale = statistics.median([r[k] for k in names]) if names else 0
            gaps = {k: abs(p.get(k, 0.0) - r[k]) / max(r[k], scale, 1e-30)
                    for k in names}
            top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
            print(f"{label}: worst leaves " + ", ".join(
                f"{k} {v:.3g} (reference norm {r[k]:.4g})" for k, v in top),
                file=sys.stderr)
            return max(gaps.values(), default=0.0)

        # a leaf the program moves and the reference does not is a fault
        stray = [k for k, v in prog["grad"].items()
                 if v > 0 and g_ref.get(k, 0.0) == 0.0]
        keep = [k for k in g_ref if g_ref[k] > 1e-3 * med]
        return dict(loss1_gap=gaps[0],
                    grad_gap=math.inf if stray else worst(
                        prog["grad"], g_ref, list(g_ref), "grad_gap"),
                    delta_gap=worst(prog["delta"], ref["delta"], keep,
                                    "delta_gap"))
