"""Random weights from the seed, made on the device in one draw.

A weight spec is the list of ``(name, shape, rule)`` of a model's
parameters in the published checkpoint's names; the benchmark hands the same
dict of tensors to the program (copied into its model) and, made again from
the seed after the program is gone, to the plain reference.  The rules
follow the random initialisations the repository's tests use, so that the
pruning decisions see scores of the same spread: BLIP linears N(0, 0.02),
CLIP linears N(0, 1/fan_in), LayerNorm scales 1, biases 0, the codebook
N(0, 1)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _clip_scale(name: str, shape, cfg: dict) -> float:
    fixed = {"visual.conv1.weight": 0.02, "token_embedding.weight": 0.02,
             "positional_embedding": 0.01, "space_dict": 1.0,
             "visual.class_embedding": cfg["vision_width"] ** -0.5,
             "visual.positional_embedding": cfg["vision_width"] ** -0.5,
             "visual.proj": cfg["vision_width"] ** -0.5,
             "text_projection": cfg["transformer_width"] ** -0.5}
    if name in fixed:
        return fixed[name]
    if len(shape) != 2:
        raise ValueError(f"no init rule for {name} {tuple(shape)}")
    return shape[-1] ** -0.5


def spec_of(named_shapes, norm_names, init: str, cfg: dict) -> Spec:
    """The spec of parameters ``named_shapes`` ((name, shape) pairs), the
    LayerNorm scales ``norm_names``, under the ``init`` rules ("blip" or
    "clip")."""
    spec = []
    for name, shape in named_shapes:
        shape = tuple(shape)
        if name in norm_names:
            rule = "one"
        elif name.endswith("bias"):
            rule = "zero"
        elif name == "logit_scale":
            rule = f"const:{math.log(1.0 / 0.07)}"
        elif name == "space_dict":
            rule = "normal:1.0"
        elif init == "blip":
            rule = "normal:0.02"
        elif init == "clip":
            rule = f"normal:{_clip_scale(name, shape, cfg)}"
        else:
            raise ValueError(f"unknown init {init!r}")
        spec.append((name, shape, rule))
    return spec


def make_weights(spec: Spec, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One normal draw of every parameter's elements from ``seed`` on
    ``device``, cut into the parameters and scaled by their rules."""
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape, rule in spec:
        n = math.prod(shape)
        view = flat[offset:offset + n].view(shape)
        offset += n
        kind, _, value = rule.partition(":")
        if kind == "one":
            view.fill_(1.0)
        elif kind == "zero":
            view.zero_()
        elif kind == "const":
            view.fill_(float(value))
        else:
            view.mul_(float(value))
        out[name] = view if dtype == torch.float32 else view.to(dtype)
    return out
