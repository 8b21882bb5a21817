"""CLI entry point of the PyTorch port: avatar training and animation on
one CUDA card.

The interface of ``main_avatar.py`` (ref: main_avatar.py:816-841):

    python main_avatar_torch.py -c configs/avatarrex_zzr/avatar.yaml -m train
    python main_avatar_torch.py -c configs/avatarrex_zzr/avatar.yaml -m test

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

import numpy as np
import torch


def main(argv=None, num_epochs: int = 10**9, device="cuda"):
    """Run the CLI on ``argv`` (default: the command line); returns the
    trainer. ``num_epochs`` bounds the training epochs; ``device`` is where
    everything runs."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config_path", type=str, required=True)
    parser.add_argument("-m", "--mode", type=str, default="train",
                        choices=["train", "test"])
    args = parser.parse_args(argv)

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
