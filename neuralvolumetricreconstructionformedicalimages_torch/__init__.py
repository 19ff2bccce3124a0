"""PyTorch + CUDA port of the neural volumetric reconstruction framework.

Mirrors ``neuralvolumetricreconstructionformedicalimages_tpu`` module for
module (same relative paths, same public names) with PyTorch idiom:
``nn.Module`` for the field, plain functions on tensors for the ops,
explicit ``device`` arguments and ``torch.Generator``s.  The four encoder
kernels the JAX package wrote in Pallas are hand-written CUDA for Hopper
(``csrc/``), built with ``nvcc`` on first use (``ops/_build.py``); each
keeps a plain PyTorch version beside it, which is what runs for tensors on
the CPU.

Entry points run on the card unless the caller asks for the CPU:
``train.trainer.Trainer(cfg, device="cpu")`` or
``python -m neuralvolumetricreconstructionformedicalimages_torch.train.cli
--config ... --device cpu``.
"""

__version__ = "0.1.0"
