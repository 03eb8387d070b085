"""The work of a forward pass from its kept counts, the numerator of every
``mfu`` metric: a frozen copy of ``madtp_tpu_torch/prune/flops.py:25-122``
(``_layer_macs``, ``vit_flops``, ``med_flops``, ``nlvr_gflops``), which
counts in fvcore's convention, one multiply-add as one "flop".  Here a
multiply-add is two operations (:data:`FLOPS_PER_MAC`), and the CLIP towers
are counted once each: the program's ``clip_gflops``
(``madtp_tpu_torch/prune/flops.py:122-149``) counts both twice, as the
reference's controller also traces the momentum towers, which an eval does
not run."""

from __future__ import annotations

from typing import Sequence

FLOPS_PER_MAC = 2
CODEBOOK = 100  # entries of MADTP's codebook


def layer_macs(n_in: float, n_out: float, D: int, I: int, n_kv: float = None) -> float:
    """qkv (3 n D^2) + scores and values (2 n n_kv D) + output projection
    (n D^2) + FFN over the tokens left after pruning (2 n_out D I)."""
    n_kv = n_in if n_kv is None else n_kv
    return 3 * n_in * D * D + 2 * n_in * n_kv * D + n_in * D * D + 2 * n_out * D * I


def vit_macs(vit: dict, kept: Sequence[int]) -> float:
    """One image through the BLIP ViT; ``kept[l]`` the patches alive after
    layer ``l`` (the merged token included)."""
    D, ps = vit["embed_dim"], vit["patch_size"]
    I = int(D * vit["mlp_ratio"])
    P = (vit["image_size"] // ps) ** 2
    total = P * (3 * ps ** 2) * D
    n_prev = P + 1
    for k in kept:
        total += layer_macs(n_prev, float(k) + 1, D, I)
        n_prev = float(k) + 1
    total += sum((float(k) + 1) * CODEBOOK * D * 2 for k in kept)  # the codebook query
    return float(total)


def med_macs(med: dict, kept: Sequence[int], n_text0: int, cross_kv: float) -> float:
    """The NLVR twin-cross text encoder over ``n_text0`` tokens, attending to
    ``cross_kv`` image tokens in each of its two streams."""
    D, I = med["hidden_size"], med["intermediate_size"]
    total, n_prev = 0.0, float(n_text0)
    for i, k in enumerate(kept):
        n_out = float(k) + 1
        total += layer_macs(n_prev, n_out, D, I)
        total += 2 * (n_out * D * D + 2 * cross_kv * D * D + 2 * n_out * cross_kv * D
                      + n_out * D * D)
        if i >= med["merge_start_layer"]:
            total += n_out * (2 * D) * D  # the merge layer
        total += n_out * CODEBOOK * D * 2
        n_prev = n_out
    return total


def nlvr_flops(cfg: dict, v_kept: Sequence[int], t_kept: Sequence[int], n_text0: int) -> float:
    """Operations of one NLVR pair: two images and the text encoder."""
    v = 2 * vit_macs(cfg["vit"], v_kept)
    t = med_macs(cfg["med"], t_kept, n_text0, float(v_kept[-1]) + 1)
    return FLOPS_PER_MAC * (v + t)


def clip_image_flops(cfg: dict, kept: Sequence[int]) -> float:
    """Operations of one image through the CLIP vision tower, once."""
    D, ps = cfg["vision_width"], cfg["vision_patch_size"]
    P = (cfg["image_resolution"] // ps) ** 2
    total = P * (3 * ps ** 2) * D
    n_prev = P + 1
    for k in kept:
        n_out = float(k) + 1
        total += layer_macs(n_prev, n_out, D, 4 * D) + n_out * CODEBOOK * D * 2
        n_prev = n_out
    total += n_prev * D * cfg["embed_dim"]
    return FLOPS_PER_MAC * float(total)


def clip_text_flops(cfg: dict, kept: Sequence[int]) -> float:
    """Operations of one caption through the CLIP text tower, once."""
    D = cfg["transformer_width"]
    total, n_prev = 0.0, float(cfg["context_length"])
    for k in kept:
        n_out = float(k) + 1
        total += layer_macs(n_prev, n_out, D, 4 * D) + n_out * CODEBOOK * D * 2
        n_prev = n_out
    return FLOPS_PER_MAC * total
