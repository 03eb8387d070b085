"""Serving artifacts of the port's eval steps
(counterpart of ``madtp_tpu/serve/artifact.py``).

An artifact directory holds two files:

``weights.pt``
    the unit's weights: a state dict in the reference ``.pth`` key layout,
    CPU tensors in the model's dtype, written by ``torch.save`` and read
    back with ``weights_only=True``.  A unit of a pipeline (a retrieval or CLIP tower,
    the ITM rerank) holds only the top-level entries it reads, as
    ``_param_subtree`` picks them in the JAX exporter.
``meta.json``
    the keys the JAX exporter writes (``task``, ``temperature``, ``mode``,
    ``capacities_vision`` / ``capacities_text``, ``inputs`` as
    ``[shape, dtype]`` pairs in call order, ``batching``, ``outputs`` and a
    task's own settings) and the port's own: ``model`` (the model family),
    ``unit``, ``config`` (the model's config as a dict), ``dtype`` (the
    compute dtype), ``torch_version`` and, when exported on a card,
    ``device_name``.

There is no graph file.  The kernels launch through ``ctypes``
(:mod:`madtp_tpu_torch.kernels.build`), which ``torch.export`` cannot see
into; so :func:`load_artifact` rebuilds the model from ``config`` and the
weights, and the unit's step from :data:`UNITS`, a registry of the port's own
step builders keyed by ``(model, unit)``.  :class:`ServingModel` runs that
step as the task's :class:`~madtp_tpu_torch.utils.graph.CapturedStep`: on
the card one CUDA graph per unit, captured by the first call (a server's
warm-up) and replayed by every later one.  Unlike a JAX artifact, the
serving process imports the port's model code.

Multi-device (mesh) artifacts are not ported: :func:`load_artifact` refuses
one with ``NotImplementedError`` (ROADMAP A.6).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from madtp_tpu_torch.core.config import BlipConfig, CLIPConfig, MedConfig, ViTConfig
from madtp_tpu_torch.core.device import resolve_device

WEIGHTS_FILE = "weights.pt"
META_FILE = "meta.json"
JAX_GRAPH_FILE = "graph.jaxexport"  # a JAX artifact's graph: not loadable here


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: numpy's and ``ml_dtypes``' names."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a spec's name (``"float32"``, ``"bfloat16"``, ...)."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


# ---------------------------------------------------------------------------
# Models: config to and from a dict, and the weights one unit keeps
# ---------------------------------------------------------------------------


def model_config(family: str, model: nn.Module) -> Dict[str, Any]:
    """``model``'s config as a JSON-ready dict, read by :func:`build_model`."""
    cfg = model.cfg
    if family == "clip":
        sd = model.space_dict
        return {"clip": dataclasses.asdict(cfg), "sd_num": 0 if sd is None else sd.shape[0]}
    out = {"vit": dataclasses.asdict(cfg.vit), "med": dataclasses.asdict(cfg.med),
           "sd_num": cfg.sd_num, "sd_dim": cfg.sd_dim}
    if family == "retrieval":
        out["embed_dim"] = model.vision_proj.out_features
    return out


def build_model(family: str, config: Dict[str, Any]) -> nn.Module:
    """An empty model of ``family`` from :func:`model_config`'s dict (built
    where the caller's ``torch.device`` context puts it)."""
    from madtp_tpu_torch.models.blip import CaptionModel, NLVRModel, RetrievalModel, VQAModel
    from madtp_tpu_torch.models.clip import CLIPModel

    if family == "clip":
        c = dict(config["clip"])
        c["resnet_layers"] = tuple(c.get("resnet_layers", ()))
        return CLIPModel(CLIPConfig(**c), int(config["sd_num"]))
    cfg = BlipConfig(vit=ViTConfig(**config["vit"]), med=MedConfig(**config["med"]),
                     sd_num=int(config["sd_num"]), sd_dim=int(config["sd_dim"]))
    if family == "retrieval":
        return RetrievalModel(cfg, int(config["embed_dim"]))
    return {"nlvr": NLVRModel, "vqa": VQAModel, "caption": CaptionModel}[family](cfg)


def keep_entries(model: nn.Module, keep: Optional[Sequence[str]]) -> nn.Module:
    """``model`` with only the top-level submodules and parameters named in
    ``keep`` (all when None); the others become None, so the unit's state
    dict and device memory hold what its step reads and nothing more."""
    if keep is not None:
        for name in list(model._modules) + list(model._parameters):
            if name not in keep:
                setattr(model, name, None)
    return model


def unit_state_dict(model: nn.Module, keep: Optional[Sequence[str]]) -> Dict[str, torch.Tensor]:
    """The unit's weights as CPU tensors in the reference key layout."""
    return {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()
            if keep is None or k.split(".")[0] in keep}


# ---------------------------------------------------------------------------
# The registry: each unit's weights, step and outputs
# ---------------------------------------------------------------------------


def _caps(meta, which):
    caps = meta.get(f"capacities_{which}")
    return None if caps is None else tuple(int(c) for c in caps)


def _statics(meta):
    bat = meta.get("batching") or {}
    return meta.get("mode", "mask") != "dense", bool(bat.get("row_independent"))


def _kept(k: torch.Tensor, ri: bool) -> torch.Tensor:
    """Kept counts as the JAX artifact gives them: int32, per-row counts
    batch-leading (``[L, B] -> [B, L]``)."""
    return (k.t() if ri else k).to(torch.int32)


def _nlvr(model, meta):
    from madtp_tpu_torch.tasks.nlvr import make_eval_step

    prune, ri = _statics(meta)
    step = make_eval_step(model, prune, _caps(meta, "vision"), _caps(meta, "text"),
                          row_independent=ri)
    return step, lambda o: (o.logits, _kept(o.v_kept, ri), _kept(o.t_kept, ri))


def _clip(tower):
    def build(model, meta):
        from madtp_tpu_torch.tasks.clip_retrieval import tower_steps

        prune, ri = _statics(meta)
        steps = tower_steps(model, prune, _caps(meta, "vision"), row_independent=ri,
                            normalize=False)
        return steps[tower], lambda o: (o[0], _kept(o[1], ri))
    return build


def _caption(model, meta):
    from madtp_tpu_torch.tasks.caption import make_caption_step

    prune, ri = _statics(meta)
    step = make_caption_step(model, prune, _caps(meta, "vision"),
                             num_beams=int(meta["num_beams"]),
                             max_length=int(meta["max_length"]),
                             min_length=int(meta["min_length"]),
                             eos_token_id=int(meta["eos_id"]), pad_token_id=int(meta["pad_id"]),
                             row_independent=ri)
    return step, lambda o: (o[0].to(torch.int32), _kept(o[1], ri))


def _vqa(model, meta):
    from madtp_tpu_torch.tasks.vqa import make_rank_step

    prune, ri = _statics(meta)
    step = make_rank_step(model, prune, _caps(meta, "vision"), _caps(meta, "text"),
                          k=int(meta["k_test"]), pad_token_id=int(meta.get("pad_id", 0)),
                          row_independent=ri)
    return step, lambda o: (o[0].to(torch.int32), o[3].to(torch.int32), _kept(o[1], ri),
                            _kept(o[2], ri))


def _retrieval(unit):
    def build(model, meta):
        from madtp_tpu_torch.tasks.retrieval import corpus_steps, itm_step

        prune, ri = _statics(meta)
        caps_v, caps_t = _caps(meta, "vision"), _caps(meta, "text")
        if unit == "itm_rerank":
            return itm_step(model, prune, caps_t, row_independent=ri), \
                lambda o: (o,)
        img, txt = corpus_steps(model, prune, caps_v, caps_t, row_independent=ri)
        if unit == "image_encoder":
            return img, lambda o: o
        return txt, lambda o: (o[0], _kept(o[1], ri))
    return build


UNITS: Dict[Tuple[str, str], Tuple[Optional[Tuple[str, ...]], Callable]] = {
    # (model, unit): (the top-level entries the unit keeps, its step builder)
    ("nlvr", "eval"): (None, _nlvr),
    ("clip", "image_encoder"): (("visual", "space_dict"), _clip(0)),
    ("clip", "text_encoder"): (("token_embedding", "positional_embedding", "transformer",
                                "ln_final", "text_projection", "space_dict"), _clip(1)),
    ("caption", "generate"): (None, _caption),
    ("vqa", "rank"): (None, _vqa),
    ("retrieval", "image_encoder"): (("visual_encoder", "space_dict", "vision_proj"),
                                     _retrieval("image_encoder")),
    ("retrieval", "text_encoder"): (("text_encoder", "space_dict", "text_proj"),
                                    _retrieval("text_encoder")),
    ("retrieval", "itm_rerank"): (("text_encoder", "space_dict", "itm_head"),
                                  _retrieval("itm_rerank")),
}


# ---------------------------------------------------------------------------
# Save and load
# ---------------------------------------------------------------------------


def input_spec(x) -> list:
    """``[shape, dtype name]`` of one call input (a tensor or a number, which
    counts as a 0-d float32, as the JAX exporter's ``jnp.float32(t)``)."""
    if torch.is_tensor(x):
        return [list(x.shape), dtype_name(x.dtype)]
    return [[], "float32"]


def save_artifact(out_dir: str, model: nn.Module, family: str, unit: str,
                  example_inputs: Sequence, *, meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``model``'s unit ``(family, unit)`` of :data:`UNITS` to
    ``out_dir``: its weights and ``meta`` with the recorded keys.  The
    ``example_inputs`` fix the served input shapes and dtypes (their values
    are not read).  The caller's ``meta`` says what the step is (mode,
    capacities, batching, a task's settings); the keys written here come
    last, so a caller cannot overwrite them.  Returns ``out_dir``."""
    if (family, unit) not in UNITS:
        raise ValueError(f"no serving unit {(family, unit)}; known: {sorted(UNITS)}")
    keep, _ = UNITS[(family, unit)]
    os.makedirs(out_dir, exist_ok=True)
    torch.save(unit_state_dict(model, keep), os.path.join(out_dir, WEIGHTS_FILE))
    dev = next(model.parameters()).device
    full = {**(meta or {}),
            "inputs": [input_spec(x) for x in example_inputs],
            "model": family, "unit": unit, "config": model_config(family, model),
            "dtype": dtype_name(next(model.parameters()).dtype),
            "torch_version": torch.__version__}
    if dev.type == "cuda":
        full["device_name"] = torch.cuda.get_device_name(dev)
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(full, f, indent=1)
    return out_dir


class ServingModel:
    """A loaded artifact: ``model(*inputs)`` runs the unit's step with the
    artifact's weights and returns its outputs as CPU tensors, in the JAX
    artifact's order, shapes and dtypes (kept counts int32).  Inputs are
    numpy arrays, tensors or numbers, each cast to its spec's dtype (same
    kind) and of exactly the spec's shape, as a fixed-shape exported graph
    takes them.

    Everything that touches the device (the inputs' upload into the
    captured step's buffers, the replay, the outputs' read-back) runs under
    ``lock``, which a server shares between all the models of its one card.
    ``rebind(state_dict)`` copies new weights into the model in place under
    that lock: the captured graphs read the weights by address
    (:mod:`madtp_tpu_torch.utils.graph`), so the next replay uses them
    without a new capture, which is what the JAX ``rebind`` gives by
    sharing the compiled graph."""

    def __init__(self, model: nn.Module, meta: Dict[str, Any], step: Callable,
                 post: Callable, device: torch.device,
                 lock: Optional[threading.Lock] = None):
        self.model, self.meta, self.step, self.post = model, meta, step, post
        self.device = device
        self.lock = lock if lock is not None else threading.Lock()
        self.specs = [(list(shape), torch_dtype(d)) for shape, d in meta["inputs"]]

    def _input(self, i: int, x) -> torch.Tensor:
        shape, dtype = self.specs[i]
        t = torch.as_tensor(x)
        if list(t.shape) != shape:
            raise ValueError(f"input {i}: shape {list(t.shape)} != exported {shape} "
                             "(the artifact is fixed-shape)")
        return t.to(self.device, dtype)

    def __call__(self, *inputs) -> List[torch.Tensor]:
        if len(inputs) != len(self.specs):
            raise ValueError(f"expected {len(self.specs)} inputs, got {len(inputs)}")
        with self.lock:
            out = self.step(*(self._input(i, x) for i, x in enumerate(inputs)))
            return [o.cpu() for o in self.post(out)]

    def rebind(self, state_dict: Dict[str, Any]) -> "ServingModel":
        """Copy ``state_dict`` (the unit's keys, as :func:`save_artifact`
        writes them) into the model's weights in place; returns ``self``."""
        sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        with self.lock, torch.no_grad():
            self.model.load_state_dict(sd, strict=True)
        return self


def load_artifact(art_dir: str, device="cuda", *,
                  lock: Optional[threading.Lock] = None) -> ServingModel:
    """Load a :func:`save_artifact` directory on ``device`` (the card by
    default: without one it raises; ``device="cpu"`` runs the plain
    PyTorch path).  ``lock``: the device lock the model takes (a server's)."""
    dev = resolve_device(device)
    with open(os.path.join(art_dir, META_FILE)) as f:
        meta = json.load(f)
    if int(meta.get("nr_devices", 1)) > 1 or meta.get("mesh"):
        raise NotImplementedError(
            "multi-device (mesh) serving artifacts are not ported yet (ROADMAP A.6)")
    if not os.path.exists(os.path.join(art_dir, WEIGHTS_FILE)):
        kind = ("a JAX artifact (graph.jaxexport)"
                if os.path.exists(os.path.join(art_dir, JAX_GRAPH_FILE)) else "no artifact")
        raise ValueError(f"{art_dir} holds {kind}: no {WEIGHTS_FILE}")
    family, unit = meta["model"], meta["unit"]
    keep, builder = UNITS[(family, unit)]
    sd = torch.load(os.path.join(art_dir, WEIGHTS_FILE), map_location="cpu", weights_only=True)
    with torch.device("meta"):
        model = keep_entries(build_model(family, meta["config"]), keep)
    model.load_state_dict(sd, strict=True, assign=True)
    model = model.to(dev, torch_dtype(meta["dtype"])).eval()
    step, post = builder(model, meta)
    return ServingModel(model, meta, step, post, dev, lock)
