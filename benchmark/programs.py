"""The system under test, built from a configuration file: the port's models
at the configuration's sizes, their weights the benchmark's
(:mod:`benchmark.weights`), made from the seed on the device."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.weights import make_weights, spec_of


def _load(model: nn.Module, cfg: dict, seed: int, device, init: str):
    """Allocate ``model`` (built on the meta device) on ``device`` and fill
    it with the seed's weights.  Returns ``(model, spec)``."""
    if any(True for _ in model.buffers()):
        raise ValueError("the model has buffers, which the weight spec does not cover")
    norms = {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, nn.LayerNorm)}
    spec = spec_of([(n, p.shape) for n, p in model.named_parameters()], norms, init, cfg)
    model = model.to_empty(device=device)
    weights = make_weights(spec, seed, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    del weights
    return model.eval(), spec


def blip_config(cfg: dict):
    from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig

    vit = ViTConfig(sd_dim=cfg["sd_dim"], **cfg["vit"])
    med = MedConfig(twin_cross=True, sd_dim=cfg["sd_dim"], **cfg["med"])
    return BlipConfig(vit=vit, med=med, sd_num=cfg["sd_num"], sd_dim=cfg["sd_dim"])


def nlvr_model(cfg: dict, seed: int, device):
    """The port's ``NLVRModel`` with the seed's weights: ``(model, spec)``."""
    from madtp_tpu_torch.models.blip import NLVRModel

    with torch.device("meta"):
        model = NLVRModel(blip_config(cfg))
    return _load(model, cfg, seed, device, "blip")


def clip_config(cfg: dict):
    from madtp_tpu_torch.core.config import CLIPConfig

    keys = ("embed_dim", "image_resolution", "vision_layers", "vision_width",
            "vision_patch_size", "context_length", "vocab_size", "transformer_width",
            "transformer_heads", "transformer_layers", "sd_dim")
    return CLIPConfig(**{k: cfg[k] for k in keys})


def clip_model(cfg: dict, seed: int, device):
    """The port's ``CLIPModel`` with the seed's weights: ``(model, spec)``."""
    from madtp_tpu_torch.models.clip import CLIPModel

    with torch.device("meta"):
        model = CLIPModel(clip_config(cfg), sd_num=cfg["sd_num"])
    return _load(model, cfg, seed, device, "clip")
