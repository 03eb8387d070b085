"""Model and DTP configuration.

Copies of the JAX package's dataclasses (``madtp_tpu/core/config.py:16-163``)
with the same fields and defaults, plus ``BlipConfig``
(``madtp_tpu/models/blip.py:32-36``), so one set of keyword arguments builds
either package's model.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """timm-style ViT used as the BLIP image encoder."""

    image_size: int = 384
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    sd_dim: int = 768  # FDT codebook dim
    drop_path_rate: float = 0.0
    grad_checkpoint: bool = False
    ckpt_layers: int = -1
    dtype: str = "float32"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class MedConfig:
    """BERT-style mixture-of-encoder-decoder config."""

    vocab_size: int = 30524
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    add_cross_attention: bool = True
    encoder_width: int = 768
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    sd_dim: int = 768
    # NLVR twin cross-attention: layers >= merge_start_layer concat the two
    # cross-attention streams through merge_layer; earlier layers average them.
    twin_cross: bool = False
    merge_start_layer: int = 6
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class DTPConfig:
    """Dynamic-token-pruning execution config: ``"mask"`` keeps a fixed
    buffer with an alive mask; ``"gather"`` compacts to the static per-layer
    ``capacities``."""

    mode: str = "mask"
    sd_num: int = 100
    sd_dim: int = 768
    capacities: Optional[Tuple[int, ...]] = None
    capacity_multiple: int = 64


class BlipConfig(NamedTuple):
    vit: ViTConfig
    med: MedConfig
    sd_num: int = 100
    sd_dim: int = 768
