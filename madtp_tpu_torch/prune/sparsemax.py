"""Sparsemax (Martins & Astudillo 2016): sort and simplex projection
(counterpart of ``madtp_tpu/prune/sparsemax.py``).

The reference builds a Sparsemax module for the MAG attention but no forward
path uses it (``Query_model.forward`` uses a softmax); kept, as in the JAX
package, for parity.
"""

from __future__ import annotations

import torch


def sparsemax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The Euclidean projection of ``x`` onto the probability simplex along
    ``dim``: ``max(x - tau, 0)`` with ``tau`` from the sorted values, in
    ``x``'s dtype."""
    x = x.movedim(dim, -1)
    d = x.shape[-1]
    x = x - x.amax(dim=-1, keepdim=True)
    zs = torch.sort(x, dim=-1, descending=True).values
    rng = torch.arange(1, d + 1, dtype=x.dtype, device=x.device)
    cssv = torch.cumsum(zs, dim=-1)
    is_gt = (1.0 + rng * zs) > cssv
    k = (is_gt * rng).amax(dim=-1, keepdim=True)
    tau = (torch.where(is_gt, zs, torch.zeros_like(zs)).sum(dim=-1, keepdim=True) - 1.0) / k
    return torch.clamp_min(x - tau, 0.0).movedim(-1, dim)
