"""Closed-form compute model, one multiply-add = one FLOP as fvcore counts
(copy of ``madtp_tpu/prune/flops.py:23-164``).  Per-layer kept counts fix the
compute of a transformer stack, so the GFLOPs the temperature controller reads
need no tracing."""

from __future__ import annotations

from typing import Sequence

from madtp_tpu_torch.core.config import CLIPConfig, MedConfig, ViTConfig
from madtp_tpu_torch.models.clip_resnet import resnet_gflops

# the reference's dense CLIP ViT-L/14@336 GFLOPs, the base of its compression
# target (madtp_tpu/cli/compress_retrieval_clip.py:26)
ORI_GFLOPS = 395.7
# the reference's dense BLIP VQA GFLOPs (madtp_tpu/cli/compress_vqa.py:30)
ORI_GFLOPS_VQA = 186.1
# the reference's dense BLIP captioning GFLOPs (madtp_tpu/cli/compress_caption.py:43)
ORI_GFLOPS_CAPTION = 65.7
# the reference's dense BLIP retrieval training GFLOPs (madtp_tpu/cli/compress_retrieval.py:28)
ORI_GFLOPS_RETRIEVAL = 153.2


def _layer_macs(n_in: float, n_out: float, D: int, I: int, n_kv: float = None):
    """qkv (3 n D^2) + scores/values (2 n n_kv D) + proj (n D^2) + FFN (2 n_out D I)."""
    n_kv = n_in if n_kv is None else n_kv
    attn = 3 * n_in * D * D + 2 * n_in * n_kv * D + n_in * D * D
    ffn = 2 * n_out * D * I
    return attn + ffn


def vit_flops(cfg: ViTConfig, kept_counts: Sequence[int]) -> float:
    """MACs for one image; ``kept_counts[l]`` = alive patches (merged
    included) after layer ``l``."""
    D = cfg.embed_dim
    I = int(D * cfg.mlp_ratio)
    total = cfg.num_patches * (3 * cfg.patch_size ** 2) * D
    n_prev = cfg.num_patches + 1
    for k in kept_counts:
        n_out = float(k) + 1
        total += _layer_macs(n_prev, n_out, D, I)
        n_prev = n_out
    # MAG query: tokens x codebook (100) + pooled features, per layer
    total += sum((float(k) + 1) * 100 * D * 2 for k in kept_counts)
    return float(total)


def med_flops(cfg: MedConfig, kept_counts: Sequence[int], n_text0: int, *,
              cross_kv: float = 0.0, twin: bool = False) -> float:
    """MACs for the text/multimodal encoder; ``cross_kv`` = image tokens seen
    by cross-attention (0 for text mode)."""
    D = cfg.hidden_size
    I = cfg.intermediate_size
    total = 0.0
    n_prev = float(n_text0)
    streams = 2 if twin else 1
    for i, k in enumerate(kept_counts):
        n_out = float(k) + 1
        total += _layer_macs(n_prev, n_out, D, I)
        if cross_kv > 0:
            per_stream = (n_out * D * D + 2 * cross_kv * D * D
                          + 2 * n_out * cross_kv * D + n_out * D * D)
            total += streams * per_stream
            if twin and i >= cfg.merge_start_layer:
                total += n_out * (2 * D) * D  # merge layer
        total += n_out * 100 * D * 2  # MAG
        n_prev = n_out
    return float(total)


def nlvr_gflops(vit_cfg: ViTConfig, med_cfg: MedConfig, v_kept: Sequence[int],
                t_kept: Sequence[int], n_text0: int) -> float:
    """Per-sample GFLOPs for BLIP-NLVR: two images plus the twin-cross text
    encoder (132.54 unpruned at 384^2)."""
    v = 2 * vit_flops(vit_cfg, v_kept)
    cross_kv = float(v_kept[-1]) + 1
    t = med_flops(med_cfg, t_kept, n_text0, cross_kv=cross_kv, twin=True)
    return (v + t) / 1e9


def caption_gflops(vit_cfg: ViTConfig, med_cfg: MedConfig, v_kept: Sequence[int],
                   n_text0: int) -> float:
    """BLIP captioning per image: the image tower and the unpruned decoder
    over ``n_text0`` tokens attending to the last layer's image tokens
    (``madtp_tpu/prune/flops.py:97-105``; the caption driver passes
    ``n_text0 = 14``; the reference's baseline is 65.7)."""
    v = vit_flops(vit_cfg, v_kept)
    cross_kv = float(v_kept[-1]) + 1
    t = med_flops(med_cfg, [n_text0 - 1] * med_cfg.num_hidden_layers, n_text0,
                  cross_kv=cross_kv)
    return (v + t) / 1e9


def retrieval_gflops(vit_cfg: ViTConfig, med_cfg: MedConfig, v_kept: Sequence[int],
                     t_kept: Sequence[int], n_text0: int) -> float:
    """BLIP retrieval's *training* forward, which the reference's controller
    traces: the online and momentum towers (x2) and ITM on the positive pair
    and two negatives (3 passes per sample); the reference's baseline is 153.2."""
    v = vit_flops(vit_cfg, v_kept)
    t = med_flops(med_cfg, t_kept, n_text0)
    cross_kv = float(v_kept[-1]) + 1
    itm = med_flops(med_cfg, t_kept, n_text0, cross_kv=cross_kv)
    return (2 * v + 2 * t + 3 * itm) / 1e9


def vqa_gflops(vit_cfg: ViTConfig, med_cfg: MedConfig, v_kept: Sequence[int],
               q_kept: Sequence[int], n_q0: int, *, n_answers: float = 1.0,
               n_ans_tokens: float = 8.0) -> float:
    """BLIP VQA per question: the image tower, the question encoder over the
    image, and ``n_answers`` passes of the answer decoder over the question
    state, ``n_ans_tokens`` tokens each (``madtp_tpu/prune/flops.py:121-135``;
    the reference's baseline is 186.1)."""
    v = vit_flops(vit_cfg, v_kept)
    cross_kv = float(v_kept[-1]) + 1
    q = med_flops(med_cfg, q_kept, n_q0, cross_kv=cross_kv)
    q_len = float(q_kept[-1]) + 1
    dec = n_answers * med_flops(med_cfg, [n_ans_tokens - 1] * med_cfg.num_hidden_layers,
                                int(n_ans_tokens), cross_kv=q_len)
    return (v + q + dec) / 1e9


def clip_gflops(cfg: CLIPConfig, v_kept: Sequence[int], t_kept: Sequence[int]) -> float:
    """Both CLIP towers per sample, twice: the reference's controller traces
    ``CLIP.forward``, which also runs the momentum towers
    (``clip/model.py:549-550``); 395.7 for ViT-L/14@336 in the reference.  An
    RN tower counts its unpruned convolutions and attention pool
    (:func:`~madtp_tpu_torch.models.clip_resnet.resnet_gflops`,
    ``madtp_tpu/prune/flops.py:141-144``) and takes no ``v_kept``."""
    Dt, It = cfg.transformer_width, cfg.transformer_width * 4
    if cfg.is_resnet:
        total = resnet_gflops(cfg.resnet_layers, cfg.vision_width, cfg.image_resolution,
                              cfg.embed_dim) * 1e9
    else:
        Dv, Iv = cfg.vision_width, cfg.vision_width * 4
        total = cfg.vision_num_patches * (3 * cfg.vision_patch_size ** 2) * Dv
        n_prev = cfg.vision_num_patches + 1
        for k in v_kept:
            n_out = float(k) + 1
            total += _layer_macs(n_prev, n_out, Dv, Iv)
            total += n_out * 100 * Dv * 2
            n_prev = n_out
        total += n_prev * Dv * cfg.embed_dim
    n_prev = float(cfg.context_length)
    for k in t_kept:
        n_out = float(k) + 1
        total += _layer_macs(n_prev, n_out, Dt, It)
        total += n_out * 100 * Dt * 2
        n_prev = n_out
    return 2 * float(total) / 1e9
