"""Elementary NN ops as plain functions on tensors
(counterpart of ``madtp_tpu/ops/layers.py:22-145``).

Weights are in PyTorch's layout (``[out, in]`` for a linear), the layout of
the reference ``.pth`` files.  A module's weights set its compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` with fp32 accumulation and the bias added in
    fp32, cast back to ``x.dtype`` (JAX: ``preferred_element_type=f32``).
    Same-dtype bf16 products go to one ``F.linear``, whose GEMM accumulates
    and adds the bias in fp32 before it rounds once; mixed dtypes compute in
    fp32."""
    if weight.dtype == x.dtype:
        return F.linear(x, weight, None if bias is None else bias.to(x.dtype))
    y = F.linear(x.float(), weight.float(),
                 None if bias is None else bias.float())
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm normalized in fp32 whatever the activation dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as torch ``nn.GELU()`` in the reference ViT/BERT."""
    return F.gelu(x)


def mlp(x: torch.Tensor, fc1: torch.nn.Linear, fc2: torch.nn.Linear,
        act=gelu) -> torch.Tensor:
    """Transformer FFN: fc1 -> act -> fc2."""
    return linear(act(linear(x, fc1.weight, fc1.bias)), fc2.weight, fc2.bias)


def patch_embed(images: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Conv-stem patchifier as reshape + one matmul.

    ``images`` [B, C, H, W]; ``weight`` the conv weight [D, C, p, p], whose
    rows flatten in (c, kh, kw) order like the JAX kernel's.  The matmul form
    keeps fp32 exact on the card (a float32 cuDNN convolution defaults to
    TF32).  Returns [B, (H/p)*(W/p), D]."""
    B, C, H, W = images.shape
    D, _, ph, pw = weight.shape
    gh, gw = H // ph, W // pw
    x = images.reshape(B, C, gh, ph, gw, pw).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(B, gh * gw, C * ph * pw)
    return linear(x, weight.reshape(D, C * ph * pw), bias)


def cosine_embedding_loss(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """torch ``nn.CosineEmbeddingLoss`` with target +1, ``mean(1 - cos(a, b))``
    over the rows, the denominator clamped at ``eps``
    (``madtp_tpu/ops/layers.py:137-145``)."""
    an = torch.sqrt((a * a).sum(dim=-1))
    bn = torch.sqrt((b * b).sum(dim=-1))
    cos = (a * b).sum(dim=-1) / torch.clamp_min(an * bn, eps)
    return (1.0 - cos).mean()
