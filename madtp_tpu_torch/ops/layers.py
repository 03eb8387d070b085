"""Elementary NN ops as plain functions on tensors
(counterpart of ``madtp_tpu/ops/layers.py:22-182``).

Weights are in PyTorch's layout (``[out, in]`` for a linear), the layout of
the reference ``.pth`` files.  A module's weights set its compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from madtp_tpu_torch.kernels.ffn import ffn_cuda


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
    """Exact (erf) GELU, as torch ``nn.GELU()`` in the reference ViT/BERT;
    computed in fp32 and rounded once for bf16 inputs."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU ``x * sigmoid(1.702 x)`` (reference
    ``clip/model.py:169-171``), computed in fp32 and rounded once to
    ``x``'s dtype, as K5 applies it."""
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


ACTIVATIONS = {"gelu": gelu, "quick_gelu": quick_gelu}


def mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
              w2: torch.Tensor, b2: Optional[torch.Tensor], act: str = "gelu") -> torch.Tensor:
    """K5's plain version: ``linear(act(linear(x, w1, b1)), w2, b2)``, the
    fc1 output rounded to ``x``'s dtype before the activation (the JAX
    package's ``_mlp_xla``)."""
    return linear(ACTIVATIONS[act](linear(x, w1, b1)), w2, b2)


class FusedMLP(torch.autograd.Function):
    """K5 forward; the backward recomputes the plain version and
    differentiates it (counterpart of ``_mlp_fused`` and its VJP,
    ``madtp_tpu/ops/layers.py:77-100``: the JAX package has no backward
    kernel for K5 either).  ``x`` is 2-D [M, D]."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.act = act
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return ffn_cuda(x, w1, b1, w2, b2, act)

    @staticmethod
    def backward(ctx, dy):
        ins = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ins, ctx.needs_input_grad[:5])]
            y = mlp_plain(*leaves, ctx.act)
            grads = iter(torch.autograd.grad(y, [t for t in leaves if t.requires_grad], dy))
        return (*(next(grads) if t.requires_grad else None for t in leaves), None)


def mlp(x: torch.Tensor, fc1: torch.nn.Linear, fc2: torch.nn.Linear,
        act: str = "gelu") -> torch.Tensor:
    """Transformer FFN: fc1 -> ``act`` (``"gelu"`` or ``"quick_gelu"``) ->
    fc2.

    On a CUDA tensor every FFN that is not fp32 goes to K5
    (:func:`ffn_cuda`, through :class:`FusedMLP` when grad mode is on and an
    input requires a gradient), which takes bf16 activations, weights and
    biases and raises on anything else.  fp32 FFNs stay on two linears (the
    fp32 train step and the card-against-CPU parity checks): fp32 on the
    tensor cores would be TF32, outside those checks' fp32 limits, and an
    fp32 CUDA-core K5 is still to be written.  CPU tensors take
    :func:`mlp_plain`."""
    w1, b1, w2, b2 = fc1.weight, fc1.bias, fc2.weight, fc2.bias
    if x.is_cuda and x.dtype != torch.float32:
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x2, w1, b1, w2, b2)):
            y = FusedMLP.apply(x2, w1, b1, w2, b2, act)
        else:
            y = ffn_cuda(x2, w1, b1, w2, b2, act)
        return y.view(*x.shape[:-1], y.shape[-1])
    return mlp_plain(x, w1, b1, w2, b2, act)


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


# CLIP normalization stats (reference data/__init__.py:20)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_images(u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """On-device normalization of a uint8 feed (``madtp_tpu/ops/layers.py:
    174-182``): uint8 [B, H, W, 3] -> [B, 3, H, W] in ``dtype``, CLIP's
    mean and std, computed in fp32."""
    x = u8.float() / 255.0  # the stats stay Python floats: no host-to-device copy
    x = torch.stack([(x[..., c] - m) / s for c, (m, s) in enumerate(zip(IMAGE_MEAN, IMAGE_STD))],
                    dim=1)
    return x.to(dtype)
