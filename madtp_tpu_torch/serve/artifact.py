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

Multi-device (mesh) artifacts (``save_artifact(..., mesh=)``, the JAX
exporter's ``nr_devices`` and ``mesh`` keys in ``meta.json``) hold the same
whole weights.  :func:`load_artifact` runs in every rank of a process group
of ``nr_devices`` ranks (:mod:`madtp_tpu_torch.parallel.dist`), rebuilds
the ``(data, model)`` mesh (:mod:`madtp_tpu_torch.parallel.mesh`) and keeps
each rank's tensor-parallel shard: a :class:`MeshServingModel`, which rank 0
calls while the other ranks run :meth:`MeshServingModel.follow`.  Every
unit of the five tasks has its rows' layout in :data:`MESH_LAYOUTS`.
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
from madtp_tpu_torch.parallel import dist
from madtp_tpu_torch.parallel import mesh as meshlib

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
    """The unit's weights as CPU tensors in the reference key layout; a
    tensor-parallel model's shards gathered back over its model group on
    their device (every rank of the group calls it)."""
    sd = {k: v.detach().contiguous() for k, v in model.state_dict().items()
          if keep is None or k.split(".")[0] in keep}
    m = getattr(model, "mesh", None)
    if m is not None and m.n_model > 1:
        import torch.distributed as tdist

        for k, dim in meshlib.model_parallel_param_specs(sd).items():
            if dim is not None:
                parts = [torch.empty_like(sd[k]) for _ in range(m.n_model)]
                tdist.all_gather(parts, sd[k], group=m.model_group)
                sd[k] = torch.cat(parts, dim=dim)
    return {k: v.cpu().contiguous() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# The registry: each unit's weights, step and outputs
# ---------------------------------------------------------------------------


def _caps(meta, which):
    caps = meta.get(f"capacities_{which}")
    return None if caps is None else tuple(int(c) for c in caps)


def _statics(meta):
    bat = meta.get("batching") or {}
    return meta.get("mode", "mask") != "dense", bool(bat.get("row_independent"))


def _graph(meta) -> bool:
    """Whether the step is captured: a mesh step's collectives cannot be
    (parallel/mesh.py), so it runs eagerly."""
    return not meta.get("mesh")


def _kept(k: torch.Tensor, ri: bool) -> torch.Tensor:
    """Kept counts as the JAX artifact gives them: int32, per-row counts
    batch-leading (``[L, B] -> [B, L]``)."""
    return (k.t() if ri else k).to(torch.int32)


def _nlvr(model, meta):
    from madtp_tpu_torch.tasks.nlvr import make_eval_step

    prune, ri = _statics(meta)
    step = make_eval_step(model, prune, _caps(meta, "vision"), _caps(meta, "text"),
                          row_independent=ri, graph=_graph(meta))
    return step, lambda o: (o.logits, _kept(o.v_kept, ri), _kept(o.t_kept, ri))


def _clip(tower):
    def build(model, meta):
        from madtp_tpu_torch.tasks.clip_retrieval import tower_steps

        prune, ri = _statics(meta)
        steps = tower_steps(model, prune, _caps(meta, "vision"), row_independent=ri,
                            normalize=False, graph=_graph(meta))
        return steps[tower], lambda o: (o[0], _kept(o[1], ri))
    return build


def _caption(model, meta):
    from madtp_tpu_torch.tasks.caption import make_caption_step

    prune, ri = _statics(meta)
    step = make_caption_step(model, prune, _caps(meta, "vision"), graph=_graph(meta),
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
                          row_independent=ri, graph=_graph(meta))
    return step, lambda o: (o[0].to(torch.int32), o[3].to(torch.int32), _kept(o[1], ri),
                            _kept(o[2], ri))


def _retrieval(unit):
    def build(model, meta):
        from madtp_tpu_torch.tasks.retrieval import corpus_steps, itm_step

        prune, ri = _statics(meta)
        caps_v, caps_t = _caps(meta, "vision"), _caps(meta, "text")
        if unit == "itm_rerank":
            return itm_step(model, prune, caps_t, row_independent=ri, graph=_graph(meta)), \
                lambda o: (o,)
        img, txt = corpus_steps(model, prune, caps_v, caps_t, row_independent=ri,
                                graph=_graph(meta))
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


# How a mesh artifact's data ranks split each unit's inputs and join its
# outputs: "rows" (leading dim, the batch), "pairs" (NLVR's [2B] image stack:
# the first images, then the second ones), "all" (every rank takes it whole:
# the temperature; an output every rank gives alike), "kept" and
# "kept_pairs" (kept counts: per row with row_independent, else the batch's,
# alike on every rank).
MESH_LAYOUTS: Dict[Tuple[str, str], Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    ("nlvr", "eval"): (("pairs", "rows", "rows", "all"), ("rows", "kept_pairs", "kept")),
    ("clip", "image_encoder"): (("rows", "all"), ("rows", "kept")),
    ("clip", "text_encoder"): (("rows", "all"), ("rows", "kept")),
    ("retrieval", "image_encoder"): (("rows", "all"), ("rows", "rows", "rows")),
    ("retrieval", "text_encoder"): (("rows", "rows", "all"), ("rows", "kept")),
    ("retrieval", "itm_rerank"): (("rows", "rows", "rows", "rows", "all"), ("rows",)),
    ("caption", "generate"): (("rows", "rows", "all"), ("rows", "kept")),
    ("vqa", "rank"): (("rows", "rows", "rows", "all", "all", "all"),
                      ("rows", "rows", "kept", "kept")),
}


def _mesh_shape(mesh) -> Tuple[int, int]:
    """``(n_data, n_model)`` of a :class:`~madtp_tpu_torch.parallel.mesh.Mesh`
    or of such a pair."""
    shape = mesh.shape if isinstance(mesh, meshlib.Mesh) else mesh
    n_data, n_model = (int(v) for v in shape)
    return n_data, n_model


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
                  example_inputs: Sequence, *, meta: Optional[Dict[str, Any]] = None,
                  mesh=None) -> str:
    """Write ``model``'s unit ``(family, unit)`` of :data:`UNITS` to
    ``out_dir``: its weights and ``meta`` with the recorded keys.  The
    ``example_inputs`` fix the served input shapes and dtypes (their values
    are not read).  The caller's ``meta`` says what the step is (mode,
    capacities, batching, a task's settings); the keys written here come
    last, so a caller cannot overwrite them.  Returns ``out_dir``.

    ``mesh`` (a :class:`~madtp_tpu_torch.parallel.mesh.Mesh` or ``(n_data,
    n_model)``): a multi-device artifact, served over that mesh; ``meta``
    records ``nr_devices`` and the mesh's axes and shape, as the JAX
    exporter does, and the weights stay whole.  A model already sharded
    over several devices (``shard_model``) needs it: every rank of its
    model group calls this (the shards are gathered back), rank 0 writes."""
    if (family, unit) not in UNITS:
        raise ValueError(f"no serving unit {(family, unit)}; known: {sorted(UNITS)}")
    placed = getattr(model, "mesh", None)
    if placed is not None and placed.size > 1 and mesh is None:
        raise ValueError(f"the model runs over {placed.size} devices — pass the mesh so the "
                         "artifact records its axes for the serving host")
    shape = None if mesh is None else _mesh_shape(mesh)
    keep, _ = UNITS[(family, unit)]
    weights = unit_state_dict(model, keep)
    if not dist.is_main_process():
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    torch.save(weights, os.path.join(out_dir, WEIGHTS_FILE))
    dev = next(model.parameters()).device
    full = {**(meta or {}),
            "inputs": [input_spec(x) for x in example_inputs],
            "model": family, "unit": unit, "config": model_config(family, model),
            "dtype": dtype_name(next(model.parameters()).dtype),
            "torch_version": torch.__version__,
            "nr_devices": 1 if shape is None else shape[0] * shape[1]}
    if shape is not None:
        full["mesh"] = {"axis_names": list(meshlib.AXIS_NAMES), "shape": list(shape)}
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


class MeshServingModel(ServingModel):
    """A mesh artifact loaded in one rank of its process group: the model
    holds the rank's tensor-parallel shard, and the rank computes its data
    index's rows.  Rank 0 calls it as a :class:`ServingModel`: the call
    hands every rank the inputs (a broadcast from rank 0), each rank runs
    the step on its rows (DTP's batch counts maxed over the data group,
    :func:`~madtp_tpu_torch.parallel.mesh.data_scope`), and rank 0 joins
    the data ranks' outputs (:data:`MESH_LAYOUTS`) into the whole result.
    The other ranks run :func:`follow` until rank 0's :meth:`close`.
    ``rebind`` (rank 0) hands every rank the new whole weights, and each
    keeps its shard of them.  ``name`` tells the models of one server apart
    on the ranks' one channel."""

    def __init__(self, model, meta, step, post, device, lock, mesh, layout, name=""):
        super().__init__(model, meta, step, post, device, lock)
        self.mesh, self.layout, self.name = mesh, layout, name

    def _rows(self, kind: str, x: torch.Tensor) -> torch.Tensor:
        if kind == "pairs":
            B = x.shape[0] // 2
            sl = meshlib.row_slice(B, self.mesh)
            return torch.cat([x[:B][sl], x[B:][sl]])
        if kind == "rows":
            return x[meshlib.row_slice(x.shape[0], self.mesh)]
        return x

    def _compute(self, inputs: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
        """This rank's rows through the step; every rank's outputs."""
        import torch.distributed as tdist

        local = [self._rows(kind, x) for kind, x in zip(self.layout[0], inputs)]
        with meshlib.data_scope(self.mesh):
            out = self.step(*(x.to(self.device) for x in local))
            out = [o.cpu() for o in self.post(out)]
        every = [None] * dist.process_count()
        tdist.all_gather_object(every, out)
        return every

    def _join(self, every) -> List[torch.Tensor]:
        ri = _statics(self.meta)[1]
        firsts = [every[i * self.mesh.n_model] for i in range(self.mesh.n_data)]
        res = []
        for k, kind in enumerate(self.layout[1]):
            if kind.startswith("kept"):
                kind = ("pairs" if kind == "kept_pairs" else "rows") if ri else "all"
            parts = [f[k] for f in firsts]
            if kind == "rows":
                res.append(torch.cat(parts))
            elif kind == "pairs":
                halves = [p.shape[0] // 2 for p in parts]
                res.append(torch.cat([p[:h] for p, h in zip(parts, halves)]
                                     + [p[h:] for p, h in zip(parts, halves)]))
            else:
                res.append(parts[0])
        return res

    def __call__(self, *inputs) -> List[torch.Tensor]:
        if not dist.is_main_process():
            raise RuntimeError("rank 0 calls a mesh artifact; the other ranks run follow()")
        if len(inputs) != len(self.specs):
            raise ValueError(f"expected {len(self.specs)} inputs, got {len(inputs)}")
        cast = []
        for i, x in enumerate(inputs):
            shape, dtype = self.specs[i]
            t = torch.as_tensor(x)
            if list(t.shape) != shape:
                raise ValueError(f"input {i}: shape {list(t.shape)} != exported {shape} "
                                 "(the artifact is fixed-shape)")
            cast.append(t.to("cpu", dtype))
            if self.layout[0][i] != "all":  # refused before any rank is asked
                meshlib.row_slice(shape[0] // (2 if self.layout[0][i] == "pairs" else 1),
                                  self.mesh)
        with self.lock:  # one call at a time on the ranks' channel
            _channel(("call", self.name, cast))
            return self._join(self._compute(cast))

    def _load_whole(self, state_dict) -> None:
        sd = meshlib.shard_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()},
                                      self.mesh)
        with torch.no_grad():
            self.model.load_state_dict(sd, strict=True)

    def rebind(self, state_dict: Dict[str, Any]) -> "MeshServingModel":
        """Rank 0: every rank copies its shard of the new whole weights in
        place."""
        sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        with self.lock:
            _channel(("rebind", self.name, sd))
            self._load_whole(sd)
        return self

    def follow(self) -> None:
        """:func:`follow` of this model alone."""
        follow({self.name: self})

    def close(self) -> None:
        """Rank 0: release the ranks in :func:`follow`."""
        with self.lock:
            _channel(("stop", self.name, None))


def _channel(msg=None):
    """Rank 0's message to every rank of the group (a broadcast); the
    message on the others."""
    import torch.distributed as tdist

    box = [msg]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def follow(models: Dict[str, MeshServingModel]) -> None:
    """The loop of a rank other than 0 over the mesh artifacts of one server
    (by name): run each call rank 0 hands out, load each rebind, return at
    rank 0's first ``close``."""
    while True:
        op, name, payload = _channel()
        if op == "call":
            models[name]._compute(payload)
        elif op == "rebind":
            models[name]._load_whole(payload)
        else:
            return


def load_artifact(art_dir: str, device="cuda", *,
                  lock: Optional[threading.Lock] = None, name: str = "") -> ServingModel:
    """Load a :func:`save_artifact` directory on ``device`` (the card by
    default: without one it raises; ``device="cpu"`` runs the plain
    PyTorch path).  ``lock``: the device lock the model takes (a server's).

    A mesh artifact loads in every rank of a process group of its
    ``nr_devices`` ranks, each on its own device (``init_from_args``): a
    :class:`MeshServingModel` (``name``: its name among a server's
    models).  A group of another size is refused."""
    dev = resolve_device(device)
    with open(os.path.join(art_dir, META_FILE)) as f:
        meta = json.load(f)
    nr = int(meta.get("nr_devices", 1))
    if nr > 1 or meta.get("mesh"):
        if not meta.get("mesh"):
            raise ValueError(f"artifact was exported for {nr} devices but records no mesh")
        if dist.process_count() != nr:
            raise ValueError(f"artifact needs {nr} devices (one process each); this group "
                             f"has {dist.process_count()}")
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
    if meta.get("mesh"):
        mesh = meshlib.make_mesh(*meta["mesh"]["shape"])
        meshlib.shard_model(model, mesh)
        step, post = builder(model, meta)
        return MeshServingModel(model, meta, step, post, dev, lock, mesh,
                                MESH_LAYOUTS[(family, unit)], name)
    step, post = builder(model, meta)
    return ServingModel(model, meta, step, post, dev, lock)
