"""Template cells: a closed loop of the program's template step
(``TemplateNet`` and ``TemplateStep`` built as ``main_template_torch.py``
builds them), steps back to back at B = 1, each on the next of the ray
batches staged on the card.

The pool is ``draws`` ray batches of each used camera of frame 0, drawn
by the dataset's own sampler (``utils/nerf.sample_rays_for_training``,
its ``rays`` rays with ``inside_ratio`` inside the mask, the mask's
boundary band left out) from the seed's images; the seed orders it. Each
step draws its depth jitter and view-direction noise from the seed's
generator on the card and ends in a host read of its loss. The first
``check_steps`` steps are the warm-up; the plain reference follows them
from the same weights, batches and draws once the window has closed.
"""

from __future__ import annotations

import contextlib
import math
import sys

import numpy as np
import torch

from .. import inputs
from .. import template_inputs as ti
from ..reference import template as ref
from . import common

SEED = 31359             # main_template_torch's seed of the net's init
FAULTS = ("no_update", "no_root_finding", "no_hands", "no_eikonal",
          "nearest_vertex")


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        c = ctx.cfg
        self.img_w, self.img_h = int(c["camera"]["img_w"]), \
            int(c["camera"]["img_h"])
        self.tcfg = c["train"]
        self.frames_per_call = 1
        self.img_size = (self.img_w, self.img_h)
        self.n_points = int(self.tcfg["rays"]) * int(self.tcfg["n_samples"])
        self.fault = None
        self.last_frames = []
        self.ref_pairs = None

    # -- set-up ----------------------------------------------------------
    def setup(self):
        ctx, t = self.ctx, self.ctx.traffic
        dev = ctx.device
        with common.part(ctx, "imports"):
            from animatablegaussians_torch.models.template import TemplateNet
            from animatablegaussians_torch.models.volume import \
                CanoBlendWeightVolume
            from animatablegaussians_torch.training import \
                template_trainer as tt
        with common.part(ctx, "fixture"):
            self.subject = ti.body(ctx.cfg, ctx.seed)
            res = int(ctx.cfg["body"]["volume_res"])
            self.volume_w = ti.weight_volume(self.subject, res, dev)
            volume = CanoBlendWeightVolume(data=dict(
                diff_weight_volume=self.volume_w.cpu().numpy(),
                volume_bounds=self.subject["volume_bounds"]), device=dev)
            self.net = TemplateNet(ctx.cfg["model"], volume, device=dev,
                                   seed=SEED)
        with common.part(ctx, "weights"):
            self.weights = ti.network_weights(ctx.cfg, ctx.seed, dev)
            self.net.load_state_dict(self.weights)
        with common.part(ctx, "inputs"):
            self._make_pool(tt)
        tc = self.tcfg
        with common.part(ctx, "optimizer"):
            optimizer, scheduler = tt.make_template_optimizer(
                self.net, tc["lr"]["network"],
                finetune_hand=bool(tc["finetune_hand"]))
            self.step = tt.TemplateStep(
                self.net, optimizer, scheduler,
                loss_weight=tc["loss_weight"],
                n_samples=int(tc["n_samples"]),
                depth_guided=tc["depth_guided_sampling"])
            self.gen = torch.Generator(device=dev).manual_seed(
                inputs.seed_of(ctx.seed, 13))
        self._plant()
        self.k = 0
        with common.part(ctx, "warm-up"):
            self._check_steps(int(t["check_steps"]))

    def _make_pool(self, tt):
        """The staged ray batches: ``draws`` a used camera, each a step's
        items on the card as ``template_trainer.template_items`` makes
        them from a dataset item."""
        from animatablegaussians_torch.utils import nerf as nerf_util
        ctx, t, s = self.ctx, self.ctx.traffic, self.subject
        extr, intr = ti.ring_cameras(ctx.cfg)
        n_cam = len(extr)
        color, mask, band = inputs.train_images(n_cam, self.img_w,
                                                self.img_h, ctx.seed,
                                                ctx.device)
        color, mask, band = (x.cpu().numpy() for x in (color, mask, band))
        rng = np.random.default_rng(inputs.seed_of(ctx.seed, 11))
        model = {k: s[k] for k in (
            "cano2live_jnt_mats", "cano_smpl_center", "mano_face_closed")}
        model.update(live_smpl_v=s["live_v"], smpl_faces=s["faces"])
        model.update({k: s[k] for k in tt.MANO_KEYS})
        tc = self.tcfg
        self.pool = []
        for c in range(n_cam):
            for _ in range(int(t["draws"])):
                rays = nerf_util.sample_rays_for_training(
                    color[c], mask[c], extr[c], intr, s["live_bounds"],
                    sample_num=int(tc["rays"]),
                    inside_ratio=float(tc["inside_ratio"]),
                    unsample_region_mask=band[c], rng=rng)
                self.pool.append(tt.template_items(
                    dict(model, nerf_random=rays), s["lbs"], ctx.device))
        self.order = common.order(ctx, len(self.pool), 14)

    def _plant(self):
        """A planted fault's lasting part (tests at small sizes only)."""
        if self.fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {self.fault!r}")
        if self.fault == "no_root_finding":
            self.net.use_root_finding = False
        elif self.fault == "no_hands":
            self.net.with_hand = False
        elif self.fault == "no_eikonal":
            self.step.loss_weight["eikonal"] = 0.0

    @contextlib.contextmanager
    def _planted_call(self):
        """The ``nearest_vertex`` fault: the body's blending weights of
        the nearest vertex in place of the barycentric face's."""
        if self.fault != "nearest_vertex":
            yield
            return
        from animatablegaussians_torch.ops import geometry3d as g3d
        orig = g3d.calc_blending_weight
        g3d.calc_blending_weight = lambda *a, **k: orig(
            *a, **dict(k, method="NN"))
        try:
            yield
        finally:
            g3d.calc_blending_weight = orig

    # -- the timed call --------------------------------------------------
    def _next(self):
        n = len(self.order)
        b = self.order[self.k % n]
        self.last_frames = [b]
        self.k += 1
        return b

    def _step(self, b: int) -> dict:
        items = self.pool[b]
        with self._planted_call():
            if self.fault == "no_update":
                self.step.optimizer.zero_grad(set_to_none=True)
                total, terms = self.step.loss(items, self.gen)
                total.backward()
            else:
                terms = self.step(items, self.gen)
        return terms

    def call(self):
        """One step: -> (frames trained, frames failed)."""
        terms = self._step(self._next())
        ok = math.isfinite(float(terms["total_loss"]))
        return 1, 0 if ok else 1

    # -- the check ------------------------------------------------------
    def _check_steps(self, n: int):
        """The first n steps through ``call``'s path, recording what the
        reference follows: each step's batch and generator state, its loss
        terms, the first step's gradient by group, and each group's change
        after the n steps."""
        params = dict(self.net.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        self.check_in, self.prog = [], dict(loss=[])
        for i in range(n):
            state = self.gen.get_state()
            b = self._next()
            terms = self._step(b)
            self.check_in.append((b, state))
            self.prog["loss"].append(_terms(terms))
            if i == 0:
                self.prog["grad"] = ref.flat_groups({
                    k: (p.grad if p.grad is not None
                        else torch.zeros_like(p)).detach().clone()
                    for k, p in params.items()})
        self.prog["delta"] = ref.flat_groups(
            {k: p.detach() - start[k] for k, p in params.items()})

    def _draws(self, state) -> dict:
        """A step's draws replayed from the generator's state before it, in
        ``render_rays``' order: the depth jitter, then the view noise."""
        g = torch.Generator(device=self.ctx.device)
        g.set_state(state)
        r, s = int(self.tcfg["rays"]), int(self.tcfg["n_samples"])
        t_rand = torch.rand((r, s), generator=g, device=self.ctx.device)
        torch.randn((r * s, 3), generator=g, device=self.ctx.device)
        return dict(t_rand=t_rand)

    def check(self, traced: list) -> dict:
        """Frees the program and holds its check steps against the plain
        reference's."""
        self.free_program()
        self.ref = self.reference()
        self.leaves = dict(program=_summary(self.prog),
                           reference=_summary(self.ref))
        return self.compare(self.prog, self.ref)

    def control(self) -> dict:
        """The control's numbers: the reference with TF32 matrix products
        in the program's place, held against the reference in float32."""
        ctl = self.reference(tf32=True)
        self.leaves["control"] = _summary(ctl)
        return self.compare(ctl, self.ref)

    def free_program(self):
        del self.net, self.step
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False) -> dict:
        """The plain reference's readings of the check steps."""
        ctx = self.ctx
        ref.set_tf32(tf32)
        try:
            volume = ref.Volume(self.volume_w, torch.as_tensor(
                self.subject["volume_bounds"], device=ctx.device))
            batches = [self.pool[b] for b, _ in self.check_in]
            draws = [self._draws(st) for _, st in self.check_in]
            out = ref.train(self.weights, volume, batches, draws, ctx.cfg)
            del volume
        finally:
            common.precision(ctx.cfg)
        return out

    @staticmethod
    def compare(prog: dict, refd: dict) -> dict:
        """The numbers compared: the first step's loss terms (the largest
        relative gap; the later steps carry the round-off that Adam turns
        into whole steps), and by the worst parameter group the relative
        L2 gap of the first gradient and of the change after the check
        steps. A group that one side moves and the other does not reads
        inf; a state left unchanged reads 1 in ``delta_gap``."""
        p1, r1 = prog["loss"][0], refd["loss"][0]
        loss1 = max(abs(p1[k] - r1[k]) / max(abs(r1[k]), 1e-30) for k in r1)
        print("loss gaps by step: " + ", ".join(
            f"{max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r):.3g}"
            for p, r in zip(prog["loss"], refd["loss"])), file=sys.stderr)

        def worst(a: dict, b: dict, label: str) -> float:
            gaps = {}
            for g, rv in b.items():
                pv = a.get(g, torch.zeros_like(rv))
                rn, dn = float(rv.norm()), float((pv - rv).norm())
                gaps[g] = dn / rn if rn > 0 else (0.0 if dn == 0
                                                  else math.inf)
            print(f"{label}: " + ", ".join(
                f"{g} {v:.3g} (reference norm {float(b[g].norm()):.4g})"
                for g, v in gaps.items()), file=sys.stderr)
            return max(gaps.values())

        return dict(loss1_gap=loss1,
                    grad_gap=worst(prog["grad"], refd["grad"], "grad_gap"),
                    delta_gap=worst(prog["delta"], refd["delta"],
                                    "delta_gap"))


def _terms(terms: dict) -> dict:
    """The program's loss terms under the reference's names."""
    names = dict(color_loss_random="color", mask_loss_random="mask",
                 eikonal_loss="eikonal", total_loss="total")
    out = {names[k]: float(v) for k, v in terms.items() if k in names}
    out.setdefault("eikonal", 0.0)
    return out


def _summary(readings: dict) -> dict:
    """A side's readings without its tensors: the losses and each group's
    norms."""
    return dict(loss=readings["loss"],
                grad={g: float(v.norm()) for g, v in readings["grad"].items()},
                delta={g: float(v.norm())
                       for g, v in readings["delta"].items()})
