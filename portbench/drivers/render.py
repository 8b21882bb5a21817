"""Animation cells: a closed loop of the program's renders, each call
waiting for its frames' uint8 RGB images on the host before the next.

``frames_per_call`` 1 calls ``AvatarNet.render`` once a frame, more calls
``AvatarNet.render_sequence`` on that many frames, as the animation CLI
batches them. Poses come from a pool on the card, in the seed's order;
the camera is the configuration's view setting: ``free`` orbits the body
by 2 pi / 216 a frame, ``moving`` looks at it from the front and follows
its centre. With ``fix_hand`` the mean hands of the pose ``fix_hand_id``
are made once at set-up and blended in on every render. Every frame of
the window is kept on the host; a sample of them drawn from the seed is
rendered again by the plain reference once the window has closed, and
the two are compared on every pixel that either side paints.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import inputs
from . import common

HAND_VERTS = 778   # vertices of one MANO hand


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t, c = ctx.traffic, ctx.cfg
        self.frames_per_call = int(t["frames_per_call"])
        self.size = int(c["test"]["img_size"])
        self.view = c["test"]["view_setting"]
        self.img_size = (self.size, self.size)
        self.bg = tuple(float(v) for v in c["test"]["bg_color"])
        self.fault = None
        self.last_frames = []
        self.ref_pairs = None

    def setup(self):
        ctx, test = self.ctx, self.ctx.cfg["test"]
        dev = ctx.device
        self.net = common.program_avatar(ctx)
        self.n_points = self.net.n_points
        with common.part(ctx, "inputs"):
            self.poses = common.PosePool(ctx, int(ctx.traffic["pose_pool"]))
            self.order = common.order(ctx, self.poses.n, 6)
            f, c = float(test["focal"]), self.size / 2
            self.intr_dev = torch.tensor([[f, 0, c], [0, f, c], [0, 0, 1]],
                                         device=dev)
            self.centre = self.poses.centres[self.order[0]].copy()
            self.hand_items = None
            if test.get("fix_hand"):
                pos = common.canonical(ctx)[0]
                self.hand_items = {
                    k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                    for k, v in inputs.hand_items(pos, HAND_VERTS).items()}
        self.hand_vals = None
        if self.hand_items is not None:
            with common.part(ctx, "mean hands"):
                self.hand_vals = self.net.generate_mean_hands(
                    self.poses.maps[self._hand_pose()][..., :3])
        self.k = 0
        self.kept = []
        with common.part(ctx, "warm-up"):
            for _ in range(2):
                self.call()
        self.kept = []

    def _hand_pose(self) -> int:
        return int(self.ctx.cfg["test"]["fix_hand_id"]) % self.poses.n

    # -- the timed call --------------------------------------------------
    def _extr(self, k: int, pose: int) -> np.ndarray:
        if self.view == "free":
            return inputs.free_view(self.centre, (k % 216) / 216 * 2 * math.pi)
        if self.view == "moving":
            extr = inputs.free_view(self.centre, 0.0)
            # later frames look at this frame's centre, as the CLI moves it
            self.centre[0] = self.poses.centres[pose][0]
            return extr
        raise ValueError(f"view setting {self.view!r} is not run here")

    def _frame(self, k: int):
        pose = self.order[k % self.poses.n]
        extr = self._extr(k, pose)
        return pose, extr, self._items(pose, extr)

    def call(self):
        """One call: -> (frames, frames failed)."""
        if self.fault == "position_off" and not hasattr(self, "_hook"):
            # the position head's output dropped where it is produced
            self._hook = self.net.position_net.register_forward_hook(
                lambda mod, args, out: torch.zeros_like(out))
        staged = [self._frame(self.k + f)
                  for f in range(self.frames_per_call)]
        self.last_frames = [(p, e) for p, e, _ in staged]
        if self.fault == "wrong_pose":
            # each frame rendered at the next frame's pose
            staged = [(p, e, self._items(
                self.order[(self.k + f + 1) % self.poses.n], e))
                for f, (p, e, _) in enumerate(staged)]
        bg = (0.0, 0.0, 0.0) if self.fault == "wrong_bg" else self.bg
        kw = dict(bg_color=bg, img_w=self.size, img_h=self.size,
                  hand_vals=self.hand_vals)
        if self.frames_per_call == 1:
            images = [self.net.render(staged[0][2], **kw)["rgb_map"]]
        else:
            seq = {k: torch.stack([s[2][k] for s in staged])
                   for k in staged[0][2]}
            images = list(self.net.render_sequence(seq, **kw)["rgb_map"])
        bad = 0
        for (pose, extr, _), img in zip(staged, images):
            u8 = common.to_u8(img)
            if self.fault == "altered":
                u8 = u8 ^ np.uint8(1)
            self.kept.append((pose, extr, u8))
            bad += 0 if bool(torch.isfinite(img).all()) else 1
        self.k += self.frames_per_call
        return self.frames_per_call, bad

    # -- the check ------------------------------------------------------
    def free_program(self):
        del self.net, self.hand_vals
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, traced: list) -> dict:
        """Frees the program and holds a sample of the window's frames
        against the plain reference's; the reference also bins the
        ``traced`` frames ((pose, camera) pairs)."""
        self.free_program()
        self.picks = self.sample()
        self.ref = self.reference_images(self.picks, traced=traced)
        return self.compare([self.kept[i][2] for i in self.picks], self.ref,
                            self.bg)

    def control(self) -> dict:
        """The control's numbers: the reference in TF32 in the program's
        place, held against the reference in float32."""
        tf32 = self.reference_images(self.picks, tf32=True)
        return self.compare([u8 for u8, _ in tf32], self.ref, self.bg)

    def sample(self) -> list:
        """The kept frames the check renders again: ``check_frames`` of
        them drawn from the seed."""
        n = min(int(self.ctx.traffic["check_frames"]), len(self.kept))
        return sorted(common.order(self.ctx, len(self.kept), 7)[:n])

    def _items(self, pose, extr):
        items = dict(smpl_pos_map=self.poses.maps[pose],
                     cano2live_jnt_mats=self.poses.mats[pose],
                     extr=torch.as_tensor(extr, device=self.ctx.device),
                     intr=self.intr_dev)
        if self.hand_items is not None:
            items.update(self.hand_items)
        return items

    def reference_images(self, picks: list, tf32: bool = False,
                         traced=()) -> list:
        """-> [(uint8 image, covered (H, W) bool)] of the plain reference
        at the picked frames' poses and cameras."""
        ctx = self.ctx
        model = common.reference_avatar(ctx, tf32)
        hands = None
        if self.hand_items is not None:
            hands = model.mean_hands(self.poses.maps[self._hand_pose()])
        if traced:
            self.ref_pairs = [model.pair_count(self._items(p, e), self.size,
                                               self.size, hands)
                              for p, e in traced]
        bg = torch.tensor(self.bg, device=ctx.device)
        out = []
        with torch.no_grad():
            for i in picks:
                pose, extr, _ = self.kept[i]
                items = self._items(pose, extr)
                img, alpha, _, _ = model.render(items, bg, self.size,
                                                self.size, hands=hands)
                out.append((common.ref_u8(img),
                            (alpha >= 1.0 / 255.0).cpu().numpy()))
        del model
        common.precision(ctx.cfg)
        return out

    @staticmethod
    def compare(images: list, ref: list, bg) -> dict:
        """differ_share: the largest share, over the frames, of painted
        pixels whose uint8 RGB differs from the reference's in a channel.
        A pixel is painted where the reference covers it (alpha >= 1/255)
        or where either image is not the background's uint8 colour, so a
        stray splat or a wrong background counts as much as a wrong
        colour on the body."""
        bg8 = (np.clip(np.asarray(bg, np.float32), 0, 1) * 255).astype(
            np.uint8)
        worst = 0.0
        for u8, (r8, cov) in zip(images, ref):
            differ = (u8 != r8).any(-1)
            painted = cov | (u8 != bg8).any(-1) | (r8 != bg8).any(-1)
            worst = max(worst, float(differ[painted].mean())
                        if painted.any() else float(differ.mean()))
        return dict(differ_share=worst)
