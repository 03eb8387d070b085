"""CLIP's ModifiedResNet vision tower, RN50/RN101-style (counterpart of
``madtp_tpu/models/clip_resnet.py``; reference ``clip/model.py:12-156``):
a 3-conv stem with an average pool, bottlenecks that average-pool before
their strided 1x1 convs (and in their downsample path), and a single-query
attention pool over the final grid in place of global pooling.

Parameter names follow the reference state dict under ``visual.`` (``conv1``,
``bn1``, ``layer1.0.conv1``, ``layer2.0.downsample.0`` / ``.1``,
``attnpool.q_proj`` ...), so a reference RN checkpoint loads by name.

Inference only, as in the JAX package: BatchNorm applies the checkpoint's
running statistics (MADTP never trains an RN tower; the JAX tower defines no
gradient path for its statistics).  DTP does not apply: there is no token
stream to prune before the attention pool, and the reference defines no RN
pruning.  The convolutions, BatchNorm and the pool's attention run as plain
PyTorch: the JAX package computes them outside any Pallas kernel
(``lax.conv_general_dilated``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from madtp_tpu_torch.ops.layers import linear, tp_linear

BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """BatchNorm on running statistics, with the reference's names
    (``weight``, ``bias``, ``running_mean``, ``running_var``); scale and
    shift are formed in fp32 and applied in the input's dtype (``_bn``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + BN_EPS)
        scale = self.weight.float() * inv
        shift = self.bias.float() - self.running_mean.float() * scale
        return x * scale.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


def _conv(in_c: int, out_c: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(in_c, out_c, k, padding=k // 2, bias=False)


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return x if k <= 1 else F.avg_pool2d(x, k)


class Bottleneck(nn.Module):
    """``clip/model.py:12-57``: 1x1, 3x3, average pool when strided, 1x1
    (x4 channels); the downsample path is an average pool, a 1x1 conv and
    BatchNorm."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), BatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), BatchNorm(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            # the reference's OrderedDict names the pool "-1", the conv "0", the norm "1"
            self.downsample = nn.ModuleDict({"0": nn.Conv2d(inplanes, planes * 4, 1, bias=False),
                                             "1": BatchNorm(planes * 4)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(_avg_pool(out, self.stride)))
        identity = x
        if self.downsample is not None:
            identity = self.downsample["1"](self.downsample["0"](_avg_pool(x, self.stride)))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """``clip/model.py:60-94``: the grid's tokens and their mean, plus a
    position embedding; one query, the mean token, attends over all of them
    with separate q/k/v projections; ``c_proj`` to ``output_dim``."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        t = x.flatten(2).transpose(1, 2)  # [B, HW, C]
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1) + self.positional_embedding
        q = linear(t[:, :1], self.q_proj.weight, self.q_proj.bias)
        k = linear(t, self.k_proj.weight, self.k_proj.bias)
        v = linear(t, self.v_proj.weight, self.v_proj.bias)
        Dh = C // self.num_heads
        qh, kh, vh = (a.unflatten(-1, (self.num_heads, Dh)).transpose(1, 2) for a in (q, k, v))
        logits = (qh.float() @ kh.float().transpose(-1, -2)) * (Dh ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(vh.dtype)
        out = (probs.float() @ vh.float()).to(vh.dtype)  # [B, H, 1, Dh]
        out = out.transpose(1, 2).reshape(B, C)
        return tp_linear(out, self.c_proj)  # row-split under tensor parallelism


class ModifiedResNet(nn.Module):
    """``[B, 3, R, R]`` images to ``[B, output_dim]`` features
    (``modified_resnet_forward``): the stem at stride 2, stages 1-4 at
    strides 1, 2, 2, 2, the attention pool with ``width * 32 // 64``
    heads."""

    def __init__(self, layers: Sequence[int], output_dim: int, width: int, resolution: int):
        super().__init__()
        self.layers_spec = tuple(layers)
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm(width // 2)
        self.conv2, self.bn2 = _conv(width // 2, width // 2, 3), BatchNorm(width // 2)
        self.conv3, self.bn3 = _conv(width // 2, width, 3), BatchNorm(width)
        inplanes = width
        for li, n in enumerate(layers):
            planes = width * 2 ** li
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(inplanes, planes, (1 if li == 0 else 2) if bi == 0 else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        embed = width * 32
        self.attnpool = AttentionPool2d(resolution // 32, embed, embed // 64, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = _avg_pool(x, 2)
        for li in range(len(self.layers_spec)):
            x = getattr(self, f"layer{li + 1}")(x)
        return self.attnpool(x)


def resnet_gflops(layers: Sequence[int], width: int, input_resolution: int,
                  output_dim: int) -> float:
    """Analytic per-image multiply-accumulates of the convolutions and the
    attention pool, in G (``madtp_tpu/models/clip_resnet.py`` ``resnet_gflops``):
    the RN tower's share of :func:`~madtp_tpu_torch.prune.flops.clip_gflops`."""
    total = 0.0
    r = input_resolution // 2
    total += r * r * (3 * 9 * (width // 2))  # conv1, stride 2
    total += r * r * (width // 2) * 9 * (width // 2)  # conv2
    total += r * r * (width // 2) * 9 * width  # conv3
    r //= 2  # the stem's average pool
    inp = width
    for li in range(4):
        planes = width * (2 ** li)
        out_c = planes * 4
        stride = 1 if li == 0 else 2
        for bi in range(layers[li]):
            s = stride if bi == 0 else 1
            total += r * r * inp * planes  # conv1 1x1
            total += r * r * planes * 9 * planes  # conv2 3x3
            rr = r // s
            total += rr * rr * planes * out_c  # conv3 1x1
            if s > 1 or inp != out_c:
                total += rr * rr * inp * out_c  # the downsample conv
            r, inp = rr, out_c
    C = width * 32
    n = r * r + 1
    total += n * C * C * 3 + n * C * 2 + C * output_dim  # the attention pool
    return total / 1e9
