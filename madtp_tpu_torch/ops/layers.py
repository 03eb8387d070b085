"""Elementary NN ops as plain functions on tensors
(counterpart of ``madtp_tpu/ops/layers.py:22-182``).

Weights are in PyTorch's layout (``[out, in]`` for a linear), the layout of
the reference ``.pth`` files.  A module's weights set its compute dtype.

The training recipe's randomness (BERT dropout, ViT drop-path) draws from
explicit streams: a step's ``torch.Generator`` gives one 63-bit key
(:func:`draw_key`), :func:`fold_in` derives a key per layer and branch from
it, as ``jax.random.fold_in`` and ``split`` do, and :func:`stream` makes the
generator a branch draws from.  A recomputed layer (remat) rebuilds the same
streams, so it draws the same masks.  Every keep mask is drawn by
:func:`keep_mask` alone.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as tdist
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


def reduce_partial(y: torch.Tensor, bias: Optional[torch.Tensor], group) -> torch.Tensor:
    """A row-split layer's output (:mod:`madtp_tpu_torch.parallel.mesh`):
    the ranks' partial sums ``y`` added in fp32 by one ``all_reduce`` over
    the model ``group``, then ``bias`` added once, rounded to ``y``'s dtype
    once."""
    from madtp_tpu_torch.parallel.dist import all_reduce

    out = all_reduce(y.float(), "sum", group)
    if bias is not None:
        out = out + bias.float()
    return out.to(y.dtype)


def tp_linear(x: torch.Tensor, mod: torch.nn.Linear) -> torch.Tensor:
    """:func:`linear` of a module's weights; a row-split linear of a
    tensor-parallel model (``mod.tp_group`` set) computes its partial sum
    and completes it with :func:`reduce_partial`.  Its input is the split
    layer's output, the rank's features; where it holds every feature
    instead (CLIP RN's attention pool, whose projections are not split),
    the rank takes its own features of it first."""
    group = getattr(mod, "tp_group", None)
    if group is None:
        return linear(x, mod.weight, mod.bias)
    width = mod.weight.shape[1]
    if x.shape[-1] != width:
        x = x.narrow(-1, tdist.get_rank(group) * width, width)
    return reduce_partial(linear(x, mod.weight), mod.bias, group)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm normalized in fp32 whatever the activation dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


_M64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def draw_key(generator: torch.Generator) -> int:
    """One 63-bit key from ``generator``: the root of a step's streams.  A
    CPU generator draws it on the host; a CUDA one waits for the card."""
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator,
                             device=generator.device))


def fold_in(key: int, data: int) -> int:
    """The key of branch ``data`` of ``key`` (the role of
    ``jax.random.fold_in``; ``fold_in(key, 0)`` and ``fold_in(key, 1)`` are
    the two halves of a split)."""
    return _mix64(key ^ _mix64(data + 1)) >> 1


def stream(key: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``key``."""
    return torch.Generator(device=device).manual_seed(key)


def keep_mask(shape, p, generator: torch.Generator, device) -> torch.Tensor:
    """Bernoulli keep flags (bool, ``shape``), each True with probability
    ``p`` (a float or a 0-d fp32 tensor): a uniform draw below ``p``, as
    ``jax.random.bernoulli`` draws them.  Every dropout and drop-path mask of
    the package is drawn here."""
    return torch.rand(shape, generator=generator, device=device) < p


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (``madtp_tpu/ops/layers.py:148-153``): kept elements
    divided by ``1 - rate``, rounded to ``x``'s dtype first as JAX rounds the
    Python float, the others 0.  The identity when ``rate`` is 0 or there is
    no generator; no mask is drawn then."""
    if rate <= 0.0 or generator is None:
        return x
    keep = keep_mask(x.shape, 1.0 - rate, generator, x.device)
    scale = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth on a residual branch ``x`` [B, ...] (timm DropPath,
    ``madtp_tpu/ops/layers.py:156-168``): one keep flag per row, shape
    ``(B, 1, ...)``, with probability ``1 - rate`` (``rate`` a 0-d fp32
    tensor); kept rows divided by ``max(1 - rate, 1e-6)``.  As in the JAX
    package the mask is drawn and the branch divided at every rate, 0
    included, and the division by an fp32 scalar gives fp32: a bf16 branch
    comes out fp32.  The identity without a generator."""
    if generator is None:
        return x
    keep_p = 1.0 - rate.float()
    keep = keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), keep_p, generator, x.device)
    y = x.float() / keep_p.clamp_min(1e-6)
    return torch.where(keep, y, torch.zeros((), dtype=y.dtype, device=y.device))


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

    On a CUDA tensor every FFN goes to K5 (:func:`ffn_cuda`, through
    :class:`FusedMLP` when grad mode is on and an input requires a
    gradient), as ``fused_mlp_2d`` takes every FFN whose weights share the
    activations' dtype on the TPU: bf16 on the tensor cores, fp32 (the
    fp32 train step, the card-against-CPU parity checks) on the CUDA cores
    without TF32.  K5 raises on any other dtype or a dtype mix.  CPU
    tensors take :func:`mlp_plain`.

    fp32 activations over weights of another dtype compute in fp32 with the
    weights upcast, as JAX's ``linear`` computes such a mix: the amp ViT's
    residual stream after the drop-path's promotion (:func:`drop_path`).

    In a tensor-parallel model (``fc2.tp_group`` set) ``fc1`` and ``fc2``
    hold the rank's ``F / n_model`` hidden features: K5 (or the plain
    version) runs on them with a zero ``b2`` and :func:`reduce_partial` adds
    the ranks' outputs and ``b2``.  Inference only."""
    group = getattr(fc2, "tp_group", None)
    if group is not None:
        w2b = fc2.bias
        zero = torch.zeros_like(w2b)
        if x.is_cuda:
            x2 = x.reshape(-1, x.shape[-1]).contiguous()
            y = ffn_cuda(x2, fc1.weight, fc1.bias, fc2.weight, zero, act)
            y = y.view(*x.shape[:-1], y.shape[-1])
        else:
            y = mlp_plain(x, fc1.weight, fc1.bias, fc2.weight, zero, act)
        return reduce_partial(y, w2b, group)
    w1, b1, w2, b2 = fc1.weight, fc1.bias, fc2.weight, fc2.bias
    if x.dtype == torch.float32 and w1.dtype != torch.float32:
        w1, b1, w2, b2 = (None if t is None else t.float() for t in (w1, b1, w2, b2))
    if x.is_cuda:
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
