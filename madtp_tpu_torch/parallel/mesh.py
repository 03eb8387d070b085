"""The (data, model) mesh and tensor parallelism over processes
(counterpart of ``madtp_tpu/parallel/mesh.py:24-33,137-176``).

A mesh lays the ranks of the joined ``torch.distributed`` group
(:func:`madtp_tpu_torch.parallel.dist.init_from_args`) out row-major as
``(data, model)``, as JAX reshapes its devices: rank ``i * n_model + j`` sits
at data index ``i`` and model index ``j``.  :func:`make_mesh` makes one group
per model row (the ranks that hold one model's shards) and one per data
column (the ranks that hold the same shard of different rows).

Tensor parallelism (TP) splits a layer's weights over the model axis by
JAX's name rule (:func:`model_parallel_param_specs`), Megatron style: the
FFN's expansion and the MED attention's query, key and value split their
output features (whole heads: the head reshape is head-major), and the
projections that close them split their input features, so each rank
computes a partial sum that one SUM ``all_reduce`` over the model group
completes.  The ViT's fused ``qkv``, CLIP's ``in_proj``, ``merge_layer``,
the LM head and the FDT codebook stay replicated.  :func:`shard_model`
gives each rank its slices and marks the modules:

* a row-split linear gets ``tp_group``: :func:`madtp_tpu_torch.ops.layers.
  tp_linear` and :func:`~madtp_tpu_torch.ops.layers.mlp` (kernel K5 on the
  rank's ``[D, F / n_model]`` and ``[F / n_model, D]``, with a zero bias)
  reduce the partial sums and add the bias once;
* a MED attention block gets its rank's head count and ``tp_group``: its
  scoring self-attention runs K1's planes variant on the rank's heads and
  combines the DTP signals over the group
  (:func:`madtp_tpu_torch.ops.attention.attention_scores`), its cross- and
  twin cross-attention run K4 on the rank's heads; the decoder's causal
  attention runs on them too, and its decode cache holds them
  (:attr:`madtp_tpu_torch.models.med.MedDecoder.heads`).

TP here is inference only, as every use of the JAX specs is (the SPMD tests
and the serving artifacts).  The data axis splits the rows: wherever DTP
couples the rows of a batch, :func:`data_scope` maxes its counts over the
data group (:func:`madtp_tpu_torch.parallel.data.batch_max`), so the mesh
takes the one-process step's decisions.  The collectives run eagerly: under
gloo (several ranks on one card, or the CPU) they cannot enter a CUDA graph,
so a mesh step is never captured; under NCCL, one card a rank, a capture of
the step with its collectives would be possible, and is not done here.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as tdist
from torch import nn

from madtp_tpu_torch.parallel import data, dist

AXIS_NAMES = ("data", "model")

# JAX's name fragments (``model_parallel_param_shardings``): a kernel whose
# path holds one of the first two splits its output features, one of the
# last its input features
EXPAND_OUT = ("fc1", "c_fc", "intermediate")
HEAD_OUT = ("query.weight", "key.weight", "value.weight")
EXPAND_IN = ("fc2", "c_proj", ".output.dense")
# the reference's NLVR head is an nn.Sequential whose linears JAX names fc1, fc2
ALIASES = (("cls_head.0.", "cls_head.fc1."), ("cls_head.2.", "cls_head.fc2."))


@dataclass
class Mesh:
    """A ``(data, model)`` mesh over the process group: ``shape`` ``(n_data,
    n_model)``, this rank's ``coords`` (None for a rank outside the mesh),
    and the groups of its model row and data column (None where the axis has
    one rank: nothing to reduce)."""

    shape: Tuple[int, int]
    coords: Optional[Tuple[int, int]]
    model_group: Optional[object] = None
    data_group: Optional[object] = None
    axis_names: Tuple[str, str] = AXIS_NAMES

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_model(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh over the joined group's first ``n_data * n_model`` ranks
    (``n_data`` defaults to the world size over ``n_model``); one process
    without a group is the 1x1 mesh.  Every rank of the group must call it,
    in the same order: ``new_group`` is collective."""
    world = dist.process_count()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} > {world} devices")
    rank = dist.process_index()
    coords = divmod(rank, n_model) if rank < n_data * n_model else None
    model_group = data_group = None
    if tdist.is_initialized():
        for i in range(n_data):  # the model rows
            g = tdist.new_group([i * n_model + j for j in range(n_model)])
            if n_model > 1 and coords is not None and coords[0] == i:
                model_group = g
        for j in range(n_model):  # the data columns
            g = tdist.new_group([i * n_model + j for i in range(n_data)])
            if n_data > 1 and coords is not None and coords[1] == j:
                data_group = g
    return Mesh((n_data, n_model), coords, model_group, data_group)


def _jax_name(name: str) -> str:
    for ours, theirs in ALIASES:
        if name.startswith(ours):
            return theirs + name[len(ours):]
    return name


def weight_spec(name: str, shape) -> Optional[int]:
    """The split dim of one tensor of the reference layout under JAX's rule:
    0 for a linear weight ``[out, in]`` whose JAX kernel splits its output
    features, 1 for one that splits its input features, None replicated
    (every tensor of fewer than 2 dims, every non-linear weight)."""
    if len(shape) != 2 or not name.endswith(".weight"):
        return None
    path = _jax_name(name)
    if any(k in path for k in EXPAND_OUT) or any(k in path for k in HEAD_OUT):
        return 0
    if any(k in path for k in EXPAND_IN):
        return 1
    return None


def model_parallel_param_specs(
        state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """Each tensor's split dim over the model axis (None: replicated), by
    JAX's rule on the port's keys (:func:`weight_spec`).  A torch weight is
    the transpose of a JAX kernel, so an output split is dim 0 and an input
    split dim 1.  The bias of a linear split by output splits with it (JAX
    keeps it whole and XLA slices it where it is added; the rank adds the
    same slice); every other bias is replicated and added once, after the
    reduce."""
    specs = {k: weight_spec(k, tuple(v.shape)) for k, v in state_dict.items()}
    for k in specs:
        if k.endswith(".bias") and specs.get(k[:-len("bias")] + "weight") == 0:
            specs[k] = 0
    return specs


def shard(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` (``t`` itself when None)."""
    if dim is None or mesh.n_model == 1:
        return t
    n = mesh.n_model
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does not split {n} ways")
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.coords[1] * size, size).contiguous()


def shard_state_dict(sd: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of each split tensor of ``sd``, the other tensors
    as they are."""
    specs = model_parallel_param_specs(sd)
    return {k: shard(v, specs[k], mesh) for k, v in sd.items()}


def _owner(model: nn.Module, name: str):
    mod_name, _, attr = name.rpartition(".")
    return model.get_submodule(mod_name) if mod_name else model, attr


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Turn ``model`` (whole weights, eval) into this rank's shard of a TP
    model, in place: the split tensors become the rank's slices, the
    row-split linears and the MED attention blocks are marked (module
    docstring).  A 1-wide model axis leaves it as it is."""
    from madtp_tpu_torch.models.med import AttentionBlock, TwinCrossAttention

    model.mesh = mesh
    if mesh.n_model == 1 or mesh.coords is None:
        return model
    n = mesh.n_model
    blocks = [m for m in model.modules() if isinstance(m, (AttentionBlock, TwinCrossAttention))]
    for m in blocks:
        if m.num_heads % n:
            raise ValueError(f"{m.num_heads} heads do not split {n} ways")
    specs = model_parallel_param_specs(dict(model.named_parameters()))
    with torch.no_grad():
        for name, dim in specs.items():
            if dim is None:
                continue
            mod, attr = _owner(model, name)
            setattr(mod, attr, nn.Parameter(shard(getattr(mod, attr).detach(), dim, mesh),
                                            requires_grad=False))
            if dim == 1:
                mod.tp_group = mesh.model_group
    for m in blocks:
        m.num_heads //= n
        m.tp_group = mesh.model_group
    return model


@contextlib.contextmanager
def data_scope(mesh: Optional[Mesh]):
    """DTP's batch-coupled counts maxed over ``mesh``'s data group inside the
    block (the step of a data rank on its rows takes the decisions of the
    one-process step on all of them); nothing with one data rank."""
    if mesh is None or mesh.data_group is None:
        yield
        return
    with data.global_batch(group=mesh.data_group):
        yield


def row_slice(n: int, mesh: Mesh) -> slice:
    """The rows of a batch of ``n`` this rank's data index holds; ``n`` must
    divide by ``n_data``."""
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.n_data} data ranks")
    per = n // mesh.n_data
    return slice(mesh.coords[0] * per, (mesh.coords[0] + 1) * per)
