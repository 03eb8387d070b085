"""BLIP-NLVR: the ViT image tower over both images of each pair, then the
twin cross-attention MED and the 2-way head
(counterpart of ``madtp_tpu/models/blip.py:39-111``, eval branch)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from madtp_tpu_torch.core.config import BlipConfig
from madtp_tpu_torch.core.device import resolve_device
from madtp_tpu_torch.models.med import MedEncoder
from madtp_tpu_torch.models.vit import VisionTransformer
from madtp_tpu_torch.ops.layers import linear
from madtp_tpu_torch.prune.dtp import TokenState


class NLVROut(NamedTuple):
    logits: torch.Tensor  # [B, 2]
    v_kept: torch.Tensor  # [L_vit]
    t_kept: torch.Tensor  # [L_med]
    overflow: Optional[torch.Tensor]  # gather mode: tokens folded into merge slots


def split_state(state: TokenState, n: int) -> Tuple[TokenState, TokenState]:
    """Rows ``[:n]`` and ``[n:]`` of a token state (``_split_state``)."""
    def part(sl):
        return TokenState(state.x[sl], state.alive[sl],
                          None if state.bias is None else state.bias[sl])
    return part(slice(None, n)), part(slice(n, None))


class NLVRModel(nn.Module):
    """Parameter names follow the reference BLIP-NLVR state dict
    (``visual_encoder.``, ``text_encoder.``, ``cls_head.0``/``.2``,
    ``space_dict``).  The model computes in the dtype of its weights."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.med.hidden_size
        self.visual_encoder = VisionTransformer(cfg.vit)
        self.text_encoder = MedEncoder(cfg.med)
        self.cls_head = nn.Sequential(nn.Linear(D, D), nn.ReLU(), nn.Linear(D, 2))
        self.space_dict = nn.Parameter(torch.zeros(cfg.sd_num, cfg.sd_dim))

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor,
                text_mask: torch.Tensor, *, temperature=0.0,
                prune_active: bool = False,
                capacities_v: Optional[Sequence[int]] = None,
                capacities_t: Optional[Sequence[int]] = None) -> NLVROut:
        """``images`` [2B, 3, H, W]: the first images of the B pairs, then the
        second ones.  ``capacities_v``/``capacities_t`` switch the towers to
        gather mode."""
        B = text_ids.shape[0]
        v = self.visual_encoder(images, space_dict=self.space_dict,
                                temperature=temperature, prune_active=prune_active,
                                capacities=capacities_v)
        st0, st1 = split_state(v.state, B)
        t = self.text_encoder(text_ids, text_mask, encoder_state=st0, encoder_state1=st1,
                              space_dict=self.space_dict, temperature=temperature,
                              prune_active=prune_active, capacities=capacities_t)
        fc1, fc2 = self.cls_head[0], self.cls_head[2]
        h = torch.relu(linear(t.state.x[:, 0, :], fc1.weight, fc1.bias))
        logits = linear(h, fc2.weight, fc2.bias)
        overflow = None
        if v.overflow is not None or t.overflow is not None:
            overflow = (0 if v.overflow is None else v.overflow) + (
                0 if t.overflow is None else t.overflow)
        return NLVROut(logits, v.kept_counts, t.kept_counts, overflow)


def init_nlvr_model(cfg: BlipConfig, seed: int = 0, device="cuda",
                    dtype=torch.float32) -> NLVRModel:
    """An NLVR model with random weights drawn from a ``torch.Generator``
    seeded with ``seed`` on the CPU, so every device gets the same weights:
    linear, conv, embedding and token weights N(0, 0.02), biases 0,
    LayerNorm scales 1, the codebook N(0, 1) (the JAX package's init)."""
    dev = resolve_device(device)
    model = NLVRModel(cfg)
    g = torch.Generator().manual_seed(seed)
    norms = {id(m.weight) for m in model.modules() if isinstance(m, nn.LayerNorm)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if id(p) in norms:
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "space_dict":
                p.copy_(torch.randn(p.shape, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    return model.to(device=dev, dtype=dtype).eval()
