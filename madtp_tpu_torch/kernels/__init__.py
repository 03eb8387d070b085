"""Hand-written Hopper kernels of the port.

| kernel | wrapper | replaces |
| --- | --- | --- |
| K1 | :func:`.attention_scores.attention_scores_cuda` | ``madtp_tpu/ops/pallas/fused_attention.py`` ``fused_attention_scores`` |

Each wrapper counts its launches in ``<wrapper>.launches``.  Sources live in
``madtp_tpu_torch/csrc`` and are built by :mod:`.build` at first use.
"""
