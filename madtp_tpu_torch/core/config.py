"""Model and DTP configuration.

Copies of the JAX package's dataclasses (``madtp_tpu/core/config.py:16-163``)
with the same fields and defaults, plus ``BlipConfig``
(``madtp_tpu/models/blip.py:32-36``), so one set of keyword arguments builds
either package's model; and :func:`infer_clip_config`, a CLIP checkpoint's
architecture from its weight shapes.
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
class CLIPConfig:
    """OpenAI-CLIP dual-tower config (``madtp_tpu/core/config.py:97-134``),
    normally inferred from a checkpoint's weight shapes.  The ViT visual
    tower only: a ``resnet_layers`` config (ModifiedResNet) raises, since that
    tower is not ported yet."""

    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 16
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    sd_dim: int = 768
    dtype: str = "float32"
    vision_heads_override: int = 0  # 0: vision_width // 64
    resnet_layers: tuple = ()

    def __post_init__(self):
        if self.resnet_layers:
            raise NotImplementedError(
                "the ModifiedResNet visual tower is not ported to madtp_tpu_torch yet")

    @property
    def vision_heads(self) -> int:
        return self.vision_heads_override or max(1, self.vision_width // 64)

    @property
    def vision_num_patches(self) -> int:
        return (self.image_resolution // self.vision_patch_size) ** 2


def infer_clip_config(sd, sd_dim: int = 768) -> CLIPConfig:
    """The ViT CLIP architecture from a reference-layout state dict's shapes
    (``madtp_tpu/cli/compress_retrieval_clip.py:54-72``; reference
    ``clip/model.py:678-701``).  A ModifiedResNet checkpoint (no
    ``visual.proj``) raises."""
    if "visual.proj" not in sd:
        raise NotImplementedError(
            "a ModifiedResNet CLIP checkpoint: that tower is not ported to madtp_tpu_torch yet")

    def shape(k):
        return tuple(sd[k].shape)

    conv = shape("visual.conv1.weight")
    grid = round((shape("visual.positional_embedding")[0] - 1) ** 0.5)
    width = shape("ln_final.weight")[0]
    return CLIPConfig(
        embed_dim=shape("text_projection")[1],
        image_resolution=conv[-1] * grid,
        vision_layers=len([k for k in sd if k.startswith("visual.")
                           and k.endswith(".attn.in_proj_weight")]),
        vision_width=conv[0],
        vision_patch_size=conv[-1],
        context_length=shape("positional_embedding")[0],
        vocab_size=shape("token_embedding.weight")[0],
        transformer_width=width,
        transformer_heads=width // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
        sd_dim=sd_dim,
    )


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
