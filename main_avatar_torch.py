"""CLI entry point of the PyTorch port: avatar training and animation on
one CUDA card, and training data parallel over several.

The interface of ``main_avatar.py`` (ref: main_avatar.py:816-841):

    python main_avatar_torch.py -c configs/avatarrex_zzr/avatar.yaml -m train
    python main_avatar_torch.py -c configs/avatarrex_zzr/avatar.yaml -m test
    torchrun --nproc_per_node=N main_avatar_torch.py -c ... -m train

Under torchrun (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` set) ``-m train``
brings up a process group, NCCL with each rank on ``cuda:LOCAL_RANK``, or
gloo with ``--device cpu``, trains data parallel
(``training/driver.py``) and tears the group down; ``-m test`` runs in one
process only. ``--device cpu`` runs on the CPU.

``-m train`` resumes from ``train.prev_ckpt``, else
``<net_ckpt_dir>/epoch_latest`` with the optimizer, else a ``pretrained``
directory (weights only), else runs the pretrain phase first; then it
trains. ``-m test`` renders the config's ``test:`` section
(``testing/animate.py::run_test``) with the weights of ``test.prev_ckpt``.
TF32 is turned off for matmuls and cuDNN convolutions (the float32 the
tests hold the port to), and a line says so.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None, num_epochs: int = 10**9, device="cuda",
         init_method=None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    trainer. ``num_epochs`` bounds the training epochs; ``device`` is where
    everything runs unless ``--device`` says otherwise; ``init_method``
    the process group's rendezvous under ``WORLD_SIZE`` (default
    torchrun's ``env://``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config_path", type=str, required=True)
    parser.add_argument("-m", "--mode", type=str, default="train",
                        choices=["train", "test"])
    parser.add_argument("--device", type=str, default=device,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.mode == "train":
        from animatablegaussians_torch.parallel import data_parallel as dp
        rank_device = dp.init_from_env(args.device, init_method)
        if rank_device is not None:
            try:
                return _run(args, num_epochs, rank_device)
            finally:
                torch.distributed.destroy_process_group()
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise ValueError("-m test runs in one process, not under a group "
                         "of WORLD_SIZE > 1")
    return _run(args, num_epochs, args.device)


def _run(args, num_epochs: int, device):
    """The CLI in this process (one rank of a group, or alone)."""
    from animatablegaussians_torch.utils.device import resolve
    device = resolve(device)
    np.random.seed(31359)  # ref: main_avatar.py:817-818
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("# TF32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False)")

    from animatablegaussians_torch.config import load_config
    from animatablegaussians_torch.training import checkpoint as ck
    from animatablegaussians_torch.training.driver import AvatarTrainer

    opt = load_config(args.config_path).to_dict()
    opt["mode"] = args.mode
    trainer = AvatarTrainer(opt, device=device)
    if args.mode == "test":
        from animatablegaussians_torch.testing.animate import run_test
        run_test(trainer, opt)
        return trainer
    if trainer.use_dp:
        # every rank decides on the same files, before rank 0 writes any
        torch.distributed.barrier()
    resume_dir, with_opt = ck.resolve_resume_dir(
        trainer.net_ckpt_dir, prev_ckpt=opt["train"].get("prev_ckpt"),
        pretrained_dir=opt["train"].get("pretrained_dir"))
    if resume_dir is None:
        trainer.pretrain()
    else:
        print(f"# Resuming from {resume_dir} "
              f"({'with' if with_opt else 'without'} the optimizer)")
        trainer.load_ckpt(resume_dir, load_optm=with_opt)
    trainer.train(num_epochs=num_epochs)
    return trainer


if __name__ == "__main__":
    main()
