"""CLI entry point of the PyTorch port: the template (SDF-NeRF) fit on one
CUDA card, the interface of ``main_template.py`` (ref:
main_template.py:146-162):

    python main_template_torch.py -c configs/avatarrex_zzr/template.yaml
        [--max_iters 150000] [--device cpu]

It reads ``cano_weight_volume.npz`` from the capture (written by
``python -m animatablegaussians_torch.tools.gen_weight_volume``), trains
``--max_iters`` iterations on the nerf-mode dataset's random rays, logs the
loss terms every 50 iterations, writes a checkpoint
(``<net_ckpt_dir>/epoch_latest``: ``net.pt`` / ``optm.pt`` with the
iteration) every 10,000, and exports the SDF's zero level set at
(256, 256, 128) to ``<data_dir>/template.ply``, which
``tools/gen_pos_maps.py`` bakes into the avatar's maps.

Unlike the JAX CLI, the dataset's mode comes from the config (every shipped
``template.yaml`` sets ``train.data.mode: nerf``; ``main_template.py:40``
passes it a second time and raises ``TypeError``), and each step's items
carry the MANO keys ``with_hand`` needs (``main_template.py:65-71`` leaves
them out). TF32 is turned off, and a line says so.
"""

from __future__ import annotations

import argparse
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

LOG_EVERY = 50
CKPT_EVERY = 10_000
SEED = 31359


def main(argv=None, device="cuda", testing_res=(256, 256, 128),
         on_step=None):
    """Run the CLI on ``argv`` (default: the command line) on ``device``
    (``--device`` overrides it). ``testing_res`` is the export's grid;
    ``on_step(it, terms)``, when given, is called after each iteration with
    the loss terms (tensors on the device). Returns a namespace with the
    net, the optimizer, the step, the dataset, the export's ``timings``
    (``sdf_s``, ``mcubes_s``), the mesh's ``n_verts`` / ``n_faces`` and the
    ``template_path``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config_path", type=str, required=True)
    parser.add_argument("--max_iters", type=int, default=150_000)
    parser.add_argument("--device", type=str, default=None)
    args = parser.parse_args(argv)

    from animatablegaussians_torch.config import load_config
    from animatablegaussians_torch.data import get_dataset_class
    from animatablegaussians_torch.models.template import TemplateNet
    from animatablegaussians_torch.models.volume import CanoBlendWeightVolume
    from animatablegaussians_torch.training import template_trainer as tt
    from animatablegaussians_torch.utils.device import resolve

    dev = resolve(args.device or device)
    np.random.seed(SEED)  # ref: main_template.py:17
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("# TF32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False)")

    opt = load_config(args.config_path).to_dict()
    data_kw = dict(opt["train"]["data"])
    data_kw.setdefault("mode", "nerf")
    if data_kw["mode"] != "nerf":
        raise ValueError(f"the template trains on the nerf mode's rays, "
                         f"not train.data.mode {data_kw['mode']!r}")
    ds_cls = get_dataset_class(opt["train"].get("dataset",
                                                "MvRgbDatasetAvatarReX"))
    dataset = ds_cls(**data_kw)
    data_dir = dataset.data_dir

    volume = CanoBlendWeightVolume(
        os.path.join(data_dir, "cano_weight_volume.npz"), device=dev)
    net = TemplateNet(opt.get("model", {}), volume, device=dev, seed=SEED)
    optimizer, scheduler = tt.make_template_optimizer(
        net, opt["train"]["lr"]["network"],
        finetune_hand=opt["train"].get("finetune_hand", False))
    step = tt.TemplateStep(
        net, optimizer, scheduler, loss_weight=opt["train"]["loss_weight"],
        depth_guided=opt["train"].get("depth_guided_sampling"))
    net_ckpt_dir = opt["train"].get("net_ckpt_dir", "./results_template")
    os.makedirs(net_ckpt_dir, exist_ok=True)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    smpl_lbs = dataset.smpl_model.data.lbs_weights.cpu().numpy()

    it = 0
    while it < args.max_iters:
        for i in range(len(dataset)):
            items = tt.template_items(dataset[i], smpl_lbs, dev)
            terms = step(items, generator)
            it += 1
            if on_step is not None:
                on_step(it, terms)
            if it % LOG_EVERY == 0:
                print(f"Iter {it}: " + ", ".join(
                    f"{k}: {float(v):.4f}" for k, v in terms.items()))
            if it % CKPT_EVERY == 0:
                tt.save_checkpoint(os.path.join(net_ckpt_dir, "epoch_latest"),
                                   net, optimizer, scheduler, it)
            if it >= args.max_iters:
                break

    # the geometry export (ref: main_template.py:96-101)
    timings = {}
    verts, faces, normals = tt.test_geometry(
        net, dataset.getitem(0, training=False), space="cano",
        testing_res=tuple(testing_res), timings=timings)
    path = os.path.join(data_dir, "template.ply")
    t0 = time.perf_counter()
    tt.save_mesh_as_ply(path, verts, faces, normals)
    timings["write_s"] = time.perf_counter() - t0
    print(f"# Exported template to {path} ({len(verts)} vertices, "
          f"{len(faces)} faces)")
    return SimpleNamespace(net=net, optimizer=optimizer, scheduler=scheduler,
                           step=step, dataset=dataset, iters=it,
                           timings=timings, n_verts=len(verts),
                           n_faces=len(faces), template_path=path,
                           net_ckpt_dir=net_ckpt_dir)


if __name__ == "__main__":
    main()
