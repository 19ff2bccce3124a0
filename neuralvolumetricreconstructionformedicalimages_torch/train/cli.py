"""Training CLI:

    python -m neuralvolumetricreconstructionformedicalimages_torch.train.cli \\
        --config configs/<name>.yaml [--workdir DIR] [--device cpu]

One ``--config`` flag (YAML with recursive ``inherit_from``), then the
trainer's main loop, on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse

from ..config import load_config
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
    trainer = Trainer(cfg, workdir=args.workdir, device=args.device)
    print(f"[Start] exp: {cfg['exp']['expname']}, net: Basic network")
    trainer.start()


if __name__ == "__main__":
    main()
