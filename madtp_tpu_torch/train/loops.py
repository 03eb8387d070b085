"""The NLVR compression train step
(counterpart of ``madtp_tpu/train/loops.py:42-103``).

Total loss ``loss_ori + 0.1 * loss_fdt``.  Dropout and drop-path stay off,
as in ``madtp_tpu/cli/compress_nlvr.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.func import functional_call

from madtp_tpu_torch.core.device import resolve_device
from madtp_tpu_torch.models.blip import NLVRModel

FDT_WEIGHT = 0.1


def _amp_cast(amp: bool, params: dict, images: torch.Tensor):
    """``--amp``: bf16 compute against fp32 master weights.  The bf16 copies
    are differentiable casts of the masters, so the gradients land on the
    fp32 masters and the optimizer state stays fp32; bf16 carries fp32's
    exponent range, so no loss scaling is needed."""
    if not amp:
        return params, images
    return ({n: p.to(torch.bfloat16) for n, p in params.items()},
            images.to(torch.bfloat16))


def make_nlvr_train_step(model: NLVRModel, optimizer: torch.optim.Optimizer, *,
                         prune_active: bool = True,
                         capacities_v: Optional[Sequence[int]] = None,
                         capacities_t: Optional[Sequence[int]] = None,
                         amp: bool = False, device="cuda"):
    """``step(images, ids, mask, targets, temperature)`` runs one forward,
    backward and optimizer update of ``model`` in place and returns
    ``{"loss", "loss_ori", "loss_fdt"}`` as device scalars; nothing in the
    step waits on the card.  ``capacities_v``/``capacities_t`` train in
    gather mode (``--fast_train``).  ``device`` is where the model must
    live: ``"cuda"`` (the default) raises without a card, ``"cpu"`` runs
    the plain path.  ``step.loss_fn`` takes the same arguments and returns
    ``(loss, loss_ori, loss_fdt)`` without the update."""
    dev = resolve_device(device)
    if model.space_dict.device.type != dev.type:
        raise ValueError(f"the model lives on {model.space_dict.device}, not {dev}")
    params = dict(model.named_parameters())
    kw = dict(prune_active=prune_active, capacities_v=capacities_v,
              capacities_t=capacities_t)

    def loss_fn(images, ids, mask, targets, temperature):
        p, x = _amp_cast(amp, params, images)
        loss_ori, loss_fdt, _ = functional_call(
            model, p, (x, ids, mask), dict(kw, temperature=temperature, targets=targets))
        return loss_ori + FDT_WEIGHT * loss_fdt, loss_ori, loss_fdt

    def step(images, ids, mask, targets, temperature):
        optimizer.zero_grad(set_to_none=True)
        loss, loss_ori, loss_fdt = loss_fn(images, ids, mask, targets, temperature)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "loss_ori": loss_ori.detach(),
                "loss_fdt": loss_fdt.detach()}

    step.loss_fn = loss_fn
    return step
