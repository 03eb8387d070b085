"""madtp-tpu in PyTorch and CUDA for one NVIDIA H100.

The same system as :mod:`madtp_tpu` (BLIP and CLIP with dynamic token
pruning at every layer), written in PyTorch.  Module names mirror the JAX package so each
function's counterpart is found at the same path:

* :mod:`.core` — configs and device selection;
* :mod:`.ops` — layers and attention (plain tensor functions);
* :mod:`.kernels` / ``csrc/`` — hand-written Hopper kernels, built with
  ``nvcc`` at first use;
* :mod:`.prune` — MAG query, DTP, capacity calibration, FLOPs model;
* :mod:`.models` — ViT, MED, the NLVR and the retrieval models, and CLIP's
  two towers, as ``nn.Module`` s;
* :mod:`.ckpt` — weights from the JAX param tree or a reference ``.pth``,
  and the checkpoint a compression run writes;
* :mod:`.eval` — retrieval recall (``itm_eval``);
* :mod:`.train` — losses, AdamW and LR schedules, the temperature
  controller, the NLVR train step (fp32 or bf16 compute on fp32 masters);
* :mod:`.tasks` — the NLVR2 eval step and loop, the train epoch and the
  ``--fast_train`` capacity probe; BLIP retrieval eval (corpus encode, ITM
  rerank, the ``--fast_eval`` probe); CLIP retrieval eval (both towers,
  ``itm_eval`` of the similarities, the ``--fast_eval`` probe); VQA and
  caption eval;
* :mod:`.utils` — the step cache and the captured steps: every eval step
  runs on the card as one CUDA graph (``graph=False`` runs it eagerly).

The package imports neither ``jax`` nor anything of :mod:`madtp_tpu`.
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
