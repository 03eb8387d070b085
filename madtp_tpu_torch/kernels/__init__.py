"""Hand-written Hopper kernels of the port.

| kernel | wrapper | replaces |
| --- | --- | --- |
| K1 | :func:`.attention_scores.attention_scores_cuda` | ``madtp_tpu/ops/pallas/fused_attention.py`` ``fused_attention_scores`` |
| K2 | :func:`.attention_scores_bwd.attention_scores_bwd_cuda` | ``madtp_tpu/ops/pallas/fused_attention.py`` ``fused_attention_scores_bwd`` |
| K4 | :func:`.cross_attention.cross_attention_cuda` | ``madtp_tpu/ops/pallas/cross_attention.py`` ``fused_cross_attention`` |
| K5 | :func:`.ffn.ffn_cuda` | ``madtp_tpu/ops/pallas/fused_ffn.py`` ``fused_mlp_2d`` |

Each wrapper counts its launches in ``<wrapper>.launches``; a launch recorded
into a CUDA graph counts once per replay of the graph, not at its capture
(:mod:`madtp_tpu_torch.utils.graph`).  Sources live in
``madtp_tpu_torch/csrc`` and are built by :mod:`.build` at first use.
"""
