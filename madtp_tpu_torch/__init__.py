"""madtp-tpu in PyTorch and CUDA for one NVIDIA H100.

The same system as :mod:`madtp_tpu` (BLIP with dynamic token pruning at every
layer), written in PyTorch.  Module names mirror the JAX package so each
function's counterpart is found at the same path:

* :mod:`.core` — configs and device selection;
* :mod:`.ops` — layers and attention (plain tensor functions);
* :mod:`.kernels` / ``csrc/`` — hand-written Hopper kernels, built with
  ``nvcc`` at first use;
* :mod:`.prune` — MAG query, DTP, capacity calibration, FLOPs model;
* :mod:`.models` — ViT, MED and the NLVR model as ``nn.Module`` s;
* :mod:`.ckpt` — weights from the JAX param tree or a reference ``.pth``;
* :mod:`.tasks` — the NLVR2 eval step and loop.

The package imports neither ``jax`` nor anything of :mod:`madtp_tpu`.
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
