"""Batch quantitative comparison over rendered-vs-GT frame directories.

Port of ``animatablegaussians_tpu/eval/comparison.py``, the generalized
rewrite of the reference's hard-coded comparison driver (ref:
eval/comparison_body_only_avatars.py:12-112): any number of method
directories against a GT directory on the reference protocol: PSNR and
SSIM on white-composited full frames (float64 on the device), LPIPS on
mask-cropped 512^2 patches, FID on the crops (only with user-supplied
Inception weights).

Frames are read with cv2 and handed on in its BGR order, as the JAX
package does. Without LPIPS weights the LPIPS is that of random weights
(``training/lpips.init_random(0)``), not a valid metric.

Usage (the card by default; ``--device cpu`` for the CPU):

    python -m animatablegaussians_torch.eval.comparison \
        --gt_dir .../images/cam18 --mask_dir .../masks/cam18 \
        --method ours=.../rgb_map --frames 2000 2500 \
        [--inception_weights inception_v3.pth]
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from animatablegaussians_torch.eval.score import (Metrics, compute_lpips,
                                                  compute_psnr, compute_ssim,
                                                  crop_image)
from animatablegaussians_torch.training.lpips import LPIPS
from animatablegaussians_torch.utils.device import resolve
from animatablegaussians_torch.utils.profiling import StageTimer


def _read(path: str) -> Optional[np.ndarray]:
    import cv2 as cv
    img = cv.imread(path, cv.IMREAD_UNCHANGED)
    if img is None:
        return None
    return (img / 255.0).astype(np.float32)


def compare_methods(method_dirs: Dict[str, str], gt_dir: str, mask_dir: str,
                    frame_list: List[int], patch_size: int = 512,
                    lpips_params: Optional[Union[dict, LPIPS]] = None,
                    name_fmt: str = "%08d.jpg",
                    gt_fmt: str = "%08d.jpg",
                    crop_out_dir: Optional[str] = None,
                    device="cuda",
                    timer: Optional[StageTimer] = None) -> Dict[str, Metrics]:
    """Returns per-method running Metrics; optionally dumps the cropped
    patches (the FID input directories, ref: comparison:59-66). PSNR, SSIM
    and LPIPS run on ``device`` (an ``LPIPS`` module as ``lpips_params``
    runs where it lives); ``timer``, when given, receives the stages
    ``read`` (the decodes and the copies to the device), ``psnr``,
    ``ssim``, ``crop`` (with the crops' writes) and ``lpips``."""
    import cv2 as cv

    dev = resolve(device)
    if isinstance(lpips_params, dict):            # loaded once, not a frame
        lpips_params = LPIPS(lpips_params, device=dev)
    timer = timer or StageTimer()
    metrics = {m: Metrics() for m in method_dirs}
    if crop_out_dir:
        for m in list(method_dirs) + ["gt"]:
            os.makedirs(os.path.join(crop_out_dir, m), exist_ok=True)

    for frame_id in frame_list:
        with timer.stage("read"):
            gt = _read(os.path.join(gt_dir, gt_fmt % frame_id))
            mask = _read(os.path.join(mask_dir, gt_fmt % frame_id))
        if gt is None or mask is None:
            continue
        mask = mask > 0.5
        if mask.ndim == 3:
            mask = mask[..., 0]
        gt = gt.copy()
        gt[~mask] = 1.0
        with timer.stage("crop"):
            gt_crop = crop_image(mask, patch_size, gt)
            if crop_out_dir:
                cv.imwrite(os.path.join(crop_out_dir, "gt",
                                        "%08d.png" % frame_id),
                           (gt_crop * 255).astype(np.uint8))
        with timer.stage("read") as out:
            out["result"] = gt_dev = torch.from_numpy(gt).to(dev)

        for m, d in method_dirs.items():
            with timer.stage("read") as out:
                img = _read(os.path.join(d, name_fmt % frame_id))
                if img is not None:
                    out["result"] = img_dev = torch.from_numpy(img).to(dev)
            if img is None:
                continue
            with timer.stage("psnr"):
                psnr = compute_psnr(img_dev, gt_dev, device=dev)
            with timer.stage("ssim"):
                ssim = compute_ssim(img_dev, gt_dev, device=dev)
            with timer.stage("crop"):
                img_crop = crop_image(mask, patch_size, img)
            with timer.stage("lpips"):
                lp = compute_lpips(img_crop, gt_crop,
                                   lpips_params=lpips_params, device=dev)
            metrics[m].update(psnr=psnr, ssim=ssim, lpips=lp)
            if crop_out_dir:
                with timer.stage("crop"):
                    cv.imwrite(os.path.join(crop_out_dir, m,
                                            "%08d.png" % frame_id),
                               (img_crop * 255).astype(np.uint8))
    return metrics


def main(argv=None) -> Dict[str, Metrics]:
    """Run the CLI on ``argv`` (default: the command line); returns the
    per-method Metrics."""
    from argparse import ArgumentParser
    ap = ArgumentParser()
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--mask_dir", required=True)
    ap.add_argument("--method", action="append", default=[],
                    help="name=dir, repeatable")
    ap.add_argument("--frames", type=int, nargs=2, default=[2000, 2500])
    ap.add_argument("--crop_out_dir", default="./tmp_quant")
    ap.add_argument("--inception_weights", default=None,
                    help="torchvision inception_v3 state dict; enables FID "
                         "over the mask-cropped patch dirs (ref: "
                         "comparison_body_only_avatars.py:97-112)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("# TF32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False)")
    print("# LPIPS: random VGG weights (training/lpips.init_random(0)), "
          "not a valid metric")

    methods = dict(m.split("=", 1) for m in args.method)
    out = compare_methods(methods, args.gt_dir, args.mask_dir,
                          list(range(*args.frames)),
                          crop_out_dir=args.crop_out_dir, device=dev)
    for name, m in out.items():
        print(f"{name} metrics: {m}")
    if args.inception_weights:
        from animatablegaussians_torch.eval.fid import (InceptionV3Features,
                                                        compute_fid)
        model = InceptionV3Features.from_torch(args.inception_weights,
                                               device=dev)
        gt_crops = os.path.join(args.crop_out_dir, "gt")
        for name in methods:
            fid = compute_fid(os.path.join(args.crop_out_dir, name),
                              gt_crops, model)
            print(f"{name} FID: {fid:.3f}")
    else:
        print("# FID: pass --inception_weights to score the crop dirs in",
              args.crop_out_dir)
    return out


if __name__ == "__main__":
    main()
