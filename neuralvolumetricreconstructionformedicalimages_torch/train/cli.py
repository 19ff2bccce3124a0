"""Training CLI:

    python -m neuralvolumetricreconstructionformedicalimages_torch.train.cli \\
        --config configs/<name>.yaml [--workdir DIR] [--device cpu]

One ``--config`` flag (YAML with recursive ``inherit_from``), then the
trainer's main loop, on the card unless ``--device`` says otherwise.

A config whose ``parallel.mesh`` spans several devices (e.g.
``{data: 4}``) runs one process a device, launched together by
``torchrun``; each process joins the group (NCCL on the cards, gloo with
``--device cpu``) and rank 0 alone evaluates, saves and prints:

    torchrun --nproc-per-node 4 \\
        -m neuralvolumetricreconstructionformedicalimages_torch.train.cli \\
        --config configs/<name>.yaml
"""

from __future__ import annotations

import argparse

from ..config import load_config
from ..parallel.mesh import initialize_multihost
from .trainer import Trainer


def config_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="./configs/chest_50.yaml",
                        help="configs file path")
    parser.add_argument("--workdir", default=None,
                        help="override experiment directory")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' to run on the CPU)")
    return parser


def main(argv=None):
    args = config_parser().parse_args(argv)
    cfg = load_config(args.config)
    initialize_multihost(device=args.device)   # under torchrun; else nothing
    trainer = Trainer(cfg, workdir=args.workdir, device=args.device)
    if trainer.rank == 0:
        print(f"[Start] exp: {cfg['exp']['expname']}, net: Basic network")
    try:
        trainer.start()
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
