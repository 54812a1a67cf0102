"""Data parallelism over ``torch.distributed``.

Counterpart of ``editanything_tpu/parallel/sharding.py``. Where JAX lays a
batch over the ``data`` axis of a device mesh and lets the compiler insert
the collectives, each rank here is one process on one device: it holds
the whole model, takes a contiguous slice of the global batch
(``shard_batch``), and the ranks meet in explicit collectives:
``gather_batch`` puts the outputs back in order, ``replicate`` broadcasts
rank 0's weights, and ``data_parallel`` wraps a trained module in
``DistributedDataParallel``, which averages its gradients. The reference
trains this way, Lightning's DDP on 8 GPUs (sam_train_sd21.py:35).

Random draws are made for the global batch on every rank, from the same
seed, and sliced like the batch, so N ranks give what one process gives
with the whole batch. JAX folds the shard index into the key of each
step's noise instead (engine/denoise.py:80-89), so there a mesh run with
DDIM's eta or the "mix" mode draws other noise than one device does.

JAX's (data, model) mesh has its counterpart below the data-parallel
helpers: ``make_mesh`` builds a ``DeviceMesh`` over the default group,
``shard_params_tp`` and ``shard_params_fsdp`` lay a module out on it with
JAX's decisions (``tp_spec``, ``fsdp_spec``), and the module then computes
with explicit collectives in autograd Functions:
- a tensor-parallel layer (the attention's ``to_q``, ``to_k``, ``to_v`` and
  GEGLU's ``ff.net.0``, column-parallel; ``to_out`` and ``ff.net.2``,
  row-parallel) holds its slice of the weight; the gradient of an
  attention's or a feed-forward's input and a row-parallel layer's output
  are summed over ``model`` (Megatron's f and g), the row-parallel bias
  added once after the sum;
- an FSDP parameter holds its slice along ``data`` and is gathered whole
  where the module reads it (a ``torch.nn.utils.parametrize``
  parametrization); its gradient is reduce-scattered back and averaged;
- every other gradient is averaged over ``data`` once the backward is done
  (``MeshLayout.reduce_gradients``).
A mesh axis of size 1 splits nothing and issues no collective.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


def default_group(group=None):
    """`group`, else the default group when ``torch.distributed`` is
    initialised (a ``torchrun`` launch), else None: one process."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank_and_size(group) -> Tuple[int, int]:
    """(this process's rank, the number of ranks) in `group`; (0, 1) for
    None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def is_main(group) -> bool:
    return rank_and_size(group)[0] == 0


def shard_batch(x: torch.Tensor, group, axis: int = 0,
                blocks: int = 1) -> torch.Tensor:
    """This rank's contiguous slice of `x` along `axis`. With `blocks` > 1
    the axis holds that many equal blocks (DreamBooth's [instance; class]
    halves) and the rank takes its slice of each, so every rank keeps whole
    pairs. The size of a block must divide by the number of ranks."""
    rank, size = rank_and_size(group)
    if size == 1:
        return x
    n = x.shape[axis]
    if n % (blocks * size):
        raise ValueError(f"a batch of {n} in {blocks} block(s) does not "
                         f"divide over {size} ranks")
    per = n // blocks // size
    parts = [x.narrow(axis, b * (n // blocks) + rank * per, per)
             for b in range(blocks)]
    return parts[0] if blocks == 1 else torch.cat(parts, dim=axis)


def gather_batch(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """Every rank's `x` concatenated along `axis` in rank order (an
    ``all_gather``; the inverse of ``shard_batch``). Each rank's `x` has
    the same shape."""
    rank, size = rank_and_size(group)
    if size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


@torch.no_grad()
def replicate(module: nn.Module, group) -> nn.Module:
    """Broadcast rank 0's parameters and buffers into every rank's
    `module`, in place; returns it."""
    if rank_and_size(group)[1] == 1:
        return module
    src = dist.get_global_rank(group, 0)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module


def data_parallel(module: nn.Module, group) -> nn.Module:
    """`module` in ``DistributedDataParallel`` over `group`: its weights
    broadcast from rank 0 at the wrap, its gradients averaged over the
    ranks in the backward."""
    device = next(module.parameters()).device
    return nn.parallel.DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=group)


def unwrap(module: nn.Module) -> nn.Module:
    """The module inside a ``data_parallel`` wrap, or `module` itself."""
    return module.module if isinstance(
        module, nn.parallel.DistributedDataParallel) else module


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of `x` over the ranks (for metrics: each rank's loss is its
    shard's)."""
    if rank_and_size(group)[1] == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x / dist.get_world_size(group)


def init_from_env(device="cuda"):
    """Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
    master's address in the environment) initialise the default group,
    nccl on the GPU and gloo on the CPU, and return this rank's device
    (``cuda:<LOCAL_RANK>`` for a CUDA `device`); otherwise return `device`
    as it is. The trainers' ``main``s call it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        cuda = device.type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method="env://",
                                device_id=device if cuda else None)
    return device


# ---------------------------------------------------------------------------
# The (data, model) mesh: tensor parallelism and FSDP
# ---------------------------------------------------------------------------

MESH_AXES = ("data", "model")
# FSDP leaves tensors below this many elements whole (JAX's fsdp_spec)
FSDP_MIN_SIZE = 1 << 16

_log = logging.getLogger(__name__)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A ``DeviceMesh`` with dims ("data", "model") over the default group,
    the model index fastest (rank = d * n_model + m, as JAX reshapes its
    devices to (n_data, n_model)), on "cuda" under nccl and "cpu" under
    gloo. `n_data` defaults to the world size // `n_model`; sizes whose
    product is not the world size raise."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "(a torchrun launch, or init_process_group)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} ranks; the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                            (n_data, n_model),
                            mesh_dim_names=MESH_AXES)


def data_group(mesh):
    """The ranks this one shares a model index with: its batch group."""
    return mesh.get_group("data")


@dataclasses.dataclass(frozen=True)
class Placement:
    """How one parameter lies on the mesh: split into equal slices along
    `dim` over `axis` ("data": FSDP; "model": tensor parallelism) or whole
    on every rank (axis None). `geglu`: the rows are GEGLU's two halves
    (``h``, ``gate``), and each rank holds its slice of each, so that its
    ``chunk(2)`` pairs them."""
    axis: Optional[str] = None
    dim: int = 0
    geglu: bool = False


REPLICATED = Placement()

# the port's dim of each axis of JAX's layout: a linear kernel is (in, out)
# where torch's weight is (out, in); a conv kernel is HWIO where torch's is
# OIHW (checkpoints/convert.py). Other ranks keep their axes.
_JAX_AXES = {2: (1, 0), 4: (2, 3, 1, 0)}
# JAX's tensor-parallel names (its slash paths; the port's dotted names map
# to them): column-parallel, then row-parallel
_TP_COLUMN = ("to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj", "fc1",
              "ff/net/0")
_TP_ROW = ("to_out", "out_proj", "fc2", "ff/net/2")


def fsdp_spec(x: torch.Tensor) -> Optional[int]:
    """The dim FSDP splits `x` along (JAX's ``fsdp_spec``: the largest axis
    of JAX's layout, the first of equals, for tensors of at least 2^16
    elements), or None."""
    if x.dim() == 0 or x.numel() < FSDP_MIN_SIZE:
        return None
    dims = _JAX_AXES.get(x.dim(), tuple(range(x.dim())))
    return dims[int(np.argmax([x.shape[d] for d in dims]))]


def tp_spec(name: str, x: torch.Tensor) -> Optional[int]:
    """The dim tensor parallelism splits the 2-D weight `name` along (JAX's
    ``tp_spec``): 0, the output rows, for a column-parallel layer; 1, the
    input columns, for a row-parallel one; None for the rest."""
    if x.dim() != 2:
        return None
    path = name.replace(".", "/")
    if any(k in path for k in _TP_COLUMN):
        return 0
    if any(k in path for k in _TP_ROW):
        return 1
    return None


def _tp_units(module: nn.Module) -> Dict[str, Tuple[Placement, int, str]]:
    """{weight name: (placement, the count that must divide by the model
    axis, its layer)} of every layer the port computes tensor-parallel: an
    attention's projections split by heads, a feed-forward's by the GEGLU
    width."""
    from editanything_tpu_torch.models.blocks import Attention, FeedForward
    units = {}
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, Attention):
            for proj in ("to_q", "to_k", "to_v"):
                units[f"{pre}{proj}.weight"] = (Placement("model", 0),
                                                m.heads, name)
            units[f"{pre}to_out.0.weight"] = (Placement("model", 1), m.heads,
                                              name)
        elif isinstance(m, FeedForward):
            inner = m.net[2].in_features
            units[f"{pre}net.0.proj.weight"] = (
                Placement("model", 0, geglu=True), inner, name)
            units[f"{pre}net.2.weight"] = (Placement("model", 1), inner, name)
    return units


def layout_plan(module: nn.Module, n_data: int, n_model: int, *,
                tp: bool = True, fsdp: bool = False
                ) -> Tuple[Dict[str, Placement], List[str]]:
    """JAX's layout of `module`'s parameters on an (n_data, n_model) mesh:
    with `tp`, ``shard_params_tp``'s (``tp_spec`` where the split divides,
    else, with `fsdp`, ``fsdp_spec`` where the largest axis divides by
    n_data, else whole); without, ``shard_params_fsdp``'s. Returns
    ({parameter name: Placement} in the module's order, the layers kept
    whole).

    One difference from JAX: a layer is split by whole heads (an attention)
    or whole GEGLU pairs, and kept whole where those do not divide by
    n_model (SD2.1's 5 heads on 2 ranks), where JAX splits the columns.
    A JAX tensor-parallel name outside those layers raises: the port has
    no tensor-parallel forward for it."""
    units = _tp_units(module) if tp else {}
    placements, kept = {}, []
    for name, p in module.named_parameters():
        place = None
        spec = tp_spec(name, p) if tp else None
        if spec is not None:
            if name not in units:
                raise ValueError(f"{name}: JAX splits it over 'model'; the "
                                 f"port has no tensor-parallel forward for "
                                 f"its layer")
            unit, count, layer = units[name]
            if count % n_model == 0:
                place = unit
            elif layer not in kept:
                kept.append(layer)
        if place is None and fsdp:
            dim = fsdp_spec(p)
            if dim is not None and p.shape[dim] % n_data == 0:
                place = Placement("data", dim)
        placements[name] = place or REPLICATED
    return placements, kept


def shard_of(full: torch.Tensor, place: Placement, index: int,
             n: int) -> torch.Tensor:
    """Rank `index`'s slice (of `n`) of the whole tensor `full`."""
    if place.geglu:
        return torch.cat([half.chunk(n, place.dim)[index]
                          for half in full.chunk(2, place.dim)], place.dim)
    return full.chunk(n, place.dim)[index]


def unshard(parts, place: Placement) -> torch.Tensor:
    """The whole tensor from every rank's slice, in rank order (the inverse
    of ``shard_of``)."""
    if place.geglu:
        halves = [p.chunk(2, place.dim) for p in parts]
        return torch.cat([h for h, _ in halves] + [g for _, g in halves],
                         place.dim)
    return torch.cat(list(parts), place.dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, out of place (the functional collective,
    which selective checkpointing can save)."""
    f = torch.ops._c10d_functional
    return f.wait_tensor(f.all_reduce(x.contiguous(), "sum",
                                      group.group_name))


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `x`, in rank order, by the synchronous collective: a
    selective checkpoint's recompute reruns it (the FSDP gathers), while
    it serves every functional collective's wait from the forward's."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model ranks (the input
    of a column-parallel layer, replicated over them, feeds each rank's
    slice of the outputs)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products of a row-parallel layer summed over the model
    ranks; the gradient passes through (each rank's slice needs all of
    it)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherShards(torch.autograd.Function):
    """An FSDP parameter gathered whole along `dim` over the data ranks; its
    gradient reduce-scattered back and averaged over them."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(_all_gather(shard, group), dim)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        f = torch.ops._c10d_functional
        x = grad.movedim(ctx.dim, 0).contiguous()
        out = f.wait_tensor(f.reduce_scatter_tensor(
            x, "sum", n, ctx.group.group_name))
        return (out / n).movedim(0, ctx.dim).contiguous(), None, None


class _Gathered(nn.Module):
    """The parametrization of an FSDP parameter: its whole tensor."""

    def __init__(self, group, dim: int):
        super().__init__()
        self.group, self.dim = group, dim

    def forward(self, shard):
        return _GatherShards.apply(shard, self.group, self.dim)


def _inputs_to_model(group):
    """A forward pre-hook for a layer whose column-parallel projections
    read its inputs (an attention, a feed-forward): each tensor input,
    whole on every model rank, has its gradient summed over them once, however
    many projections read it (q, k and v one self-attention input)."""
    def copy(a):
        return _CopyToModel.apply(a, group) if torch.is_tensor(a) else a

    def hook(module, args, kwargs):
        return (tuple(copy(a) for a in args),
                {k: copy(v) for k, v in kwargs.items()})
    return hook


class ColumnParallelLinear(nn.Module):
    """A linear layer holding this rank's rows of the weight (the rows of
    `place`'s slice); its bias stays whole and each rank adds its rows of
    it. Its layer's pre-hook (``_inputs_to_model``) sums the input's
    gradient over the model ranks."""

    def __init__(self, linear: nn.Linear, place: Placement, group,
                 index: int, n: int):
        super().__init__()
        self.weight, self.bias = linear.weight, linear.bias
        self.group = group
        rows = linear.out_features // (2 if place.geglu else 1)
        k = rows // n
        # (start, length) of this rank's rows in the whole bias
        self.segments = [(h * rows + index * k, k)
                         for h in range(2 if place.geglu else 1)]

    def forward(self, x):
        bias = None
        if self.bias is not None:
            b = _CopyToModel.apply(self.bias, self.group)
            bias = torch.cat([b.narrow(0, s, k) for s, k in self.segments])
        return F.linear(x, self.weight, bias)


class RowParallelLinear(nn.Module):
    """A linear layer holding this rank's columns of the weight: its
    partial products summed over the model ranks, then the whole bias
    added once."""

    def __init__(self, linear: nn.Linear, group):
        super().__init__()
        self.weight, self.bias = linear.weight, linear.bias
        self.group = group

    def forward(self, x):
        y = _ReduceFromModel.apply(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class MeshLayout:
    """A module's parameters laid out on a mesh (``module.mesh_layout``,
    set by ``shard_params_tp`` / ``shard_params_fsdp``): each parameter's
    placement by its name in the whole module, the parameters themselves
    (each holding this rank's slice), and the collectives that the train
    step, the checkpoints and the export run over them. Every rank calls
    each method in the same order: they are collectives."""

    def __init__(self, mesh, placements: Dict[str, Placement],
                 params: Dict[str, nn.Parameter], keys: List[str],
                 kept_whole: List[str]):
        self.mesh = mesh
        self.groups = {a: mesh.get_group(a) for a in MESH_AXES}
        self.sizes = {a: mesh.size(i) for i, a in enumerate(MESH_AXES)}
        self.index = {a: mesh.get_local_rank(a) for a in MESH_AXES}
        self.placements = placements
        self.params = params
        self.shapes = {id(p): p.shape for p in params.values()}
        self.keys = keys              # the whole module's state_dict keys
        self.kept_whole = kept_whole

    def split(self, place: Placement) -> bool:
        """Whether the placement splits the tensor: its axis is longer
        than 1."""
        return place.axis is not None and self.sizes[place.axis] > 1

    def shard(self, full: torch.Tensor, place: Placement) -> torch.Tensor:
        """This rank's slice of a whole tensor."""
        if not self.split(place):
            return full
        return shard_of(full, place, self.index[place.axis],
                        self.sizes[place.axis]).contiguous()

    def full(self, local: torch.Tensor, place: Placement) -> torch.Tensor:
        """The whole tensor from every rank's slice (an all-gather over the
        placement's axis)."""
        local = local.detach()
        if not self.split(place):
            return local
        return unshard(_all_gather(local, self.groups[place.axis]), place)

    def placement_of(self, param) -> Placement:
        for name, p in self.params.items():
            if p is param:
                return self.placements[name]
        raise KeyError("not a parameter of this layout")

    def reduce_gradients(self) -> None:
        """Average over the data ranks every gradient that an FSDP gather's
        backward did not (in one flat all-reduce). The model ranks of one
        data group hold the same gradient of a whole tensor, and each its
        own slice's of a split one: neither is summed over them."""
        n = self.sizes["data"]
        if n == 1:
            return
        grads = [p.grad for name, p in self.params.items()
                 if p.grad is not None
                 and not (self.placements[name].axis == "data"
                          and self.split(self.placements[name]))]
        if not grads:
            return
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=self.groups["data"])
        flat /= n
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)

    def sum_over_shards(self, values) -> torch.Tensor:
        """The sum of per-parameter `values` of this rank's slices (square
        sums: ``global_norm``), each whole tensor counted once: the sums of
        split tensors are summed over the ranks of their axis."""
        total = None
        for axis, s in sums_by_axis(self.placements.values(), values,
                                    self.sizes).items():
            if axis is not None:
                s = _all_reduce(s, self.groups[axis])
            total = s if total is None else total + s
        return total


def sums_by_axis(placements, values, sizes) -> Dict[Optional[str], object]:
    """{axis: the sum of the `values` (one per placement) of the tensors
    split over that axis}, None summing the tensors whole on every rank
    (a placement over an axis of size 1 among them)."""
    sums = {}
    for place, v in zip(placements, values):
        axis = place.axis if place.axis and sizes[place.axis] > 1 else None
        sums[axis] = sums[axis] + v if axis in sums else v
    return sums


def layout_of(module: nn.Module) -> Optional[MeshLayout]:
    """The module's mesh layout, None for a module that is whole."""
    return getattr(module, "mesh_layout", None)


def _lay_out(mesh, module: nn.Module, placements, kept) -> nn.Module:
    from torch.nn.utils import parametrize
    if layout_of(module) is not None:
        raise ValueError("the module is laid out on a mesh already")
    params = dict(module.named_parameters())
    layout = MeshLayout(mesh, placements, params,
                        list(module.state_dict().keys()), kept)
    for name, place in placements.items():
        if not layout.split(place):
            continue
        p = params[name]
        with torch.no_grad():
            p.data = layout.shard(p.data, place)
        owner, _, attr = name.rpartition(".")
        if place.axis == "data":
            parametrize.register_parametrization(
                module.get_submodule(owner), attr,
                _Gathered(layout.groups["data"], place.dim), unsafe=True)
            continue
        parent, _, child = owner.rpartition(".")
        linear = module.get_submodule(owner)
        if linear.bias is not None and layout.split(
                placements[f"{owner}.bias"]):
            raise ValueError(f"{owner}: a split bias on a tensor-parallel "
                             f"layer")
        group = layout.groups["model"]
        setattr(module.get_submodule(parent), child,
                ColumnParallelLinear(linear, place, group,
                                     layout.index["model"],
                                     layout.sizes["model"])
                if place.dim == 0 else RowParallelLinear(linear, group))
    from editanything_tpu_torch.models.blocks import Attention, FeedForward
    for m in module.modules():
        if isinstance(m, (Attention, FeedForward)) and any(
                isinstance(c, ColumnParallelLinear) for c in m.modules()):
            m.register_forward_pre_hook(
                _inputs_to_model(layout.groups["model"]), with_kwargs=True)
    module.mesh_layout = layout
    for layer in kept:
        _log.warning("tensor parallelism keeps %s whole: its heads do not "
                     "divide by the model axis (%d)", layer,
                     layout.sizes["model"])
    return module


def shard_params_tp(mesh, module: nn.Module, *,
                    also_fsdp: bool = False) -> nn.Module:
    """Lay `module` out on `mesh` in place (JAX's ``shard_params_tp``):
    attention and GEGLU layers split over "model" where their heads divide,
    else (with `also_fsdp`) the tensors of at least 2^16 elements split over
    "data" along their largest axis where it divides, else whole. The
    parameters stay the same objects (an optimizer over them stays valid
    while it holds no state). Returns the module."""
    placements, kept = layout_plan(module, mesh.size(0), mesh.size(1),
                                   tp=True, fsdp=also_fsdp)
    return _lay_out(mesh, module, placements, kept)


def shard_params_fsdp(mesh, module: nn.Module) -> nn.Module:
    """Lay `module` out on `mesh` by FSDP alone (JAX's
    ``shard_params_fsdp``): every tensor of at least 2^16 elements split
    over "data" along its largest axis where it divides. Returns the
    module."""
    placements, kept = layout_plan(module, mesh.size(0), mesh.size(1),
                                   tp=False, fsdp=True)
    return _lay_out(mesh, module, placements, kept)


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's ``state_dict`` as the whole module's: on a mesh every
    split tensor gathered (a collective: every rank calls it), under the
    whole module's names and in its order."""
    layout = layout_of(module)
    if layout is None:
        return module.state_dict()
    return {k: layout.full(layout.params[k], layout.placements[k])
            if k in layout.params else module.get_buffer(k)
            for k in layout.keys}


@torch.no_grad()
def load_full_state_dict(module: nn.Module, sd) -> None:
    """Load a whole module's ``state_dict`` (strict), each rank keeping its
    slices."""
    layout = layout_of(module)
    if layout is None:
        module.load_state_dict(sd)
        return
    if sorted(sd) != sorted(layout.keys):
        raise KeyError(f"state dict keys differ: missing "
                       f"{sorted(set(layout.keys) - set(sd))[:5]}, unexpected "
                       f"{sorted(set(sd) - set(layout.keys))[:5]}")
    for k in layout.keys:
        target = layout.params.get(k)
        if target is None:
            module.get_buffer(k).copy_(sd[k])
            continue
        target.copy_(layout.shard(sd[k].to(target.device),
                                  layout.placements[k]))


def _optimizer_params(optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(optimizer, module: nn.Module) -> dict:
    """The optimizer's ``state_dict`` with each per-element state tensor
    (Adam's moments) gathered whole like its parameter (a collective)."""
    sd = optimizer.state_dict()
    layout = layout_of(module)
    if layout is None:
        return sd
    params = _optimizer_params(optimizer)
    state = {}
    for i, s in sd["state"].items():
        p = params[i]
        place = layout.placement_of(p)
        state[i] = {k: layout.full(v, place) if torch.is_tensor(v)
                    and v.dim() and v.shape == p.shape else v
                    for k, v in s.items()}
    return {**sd, "state": state}


def shard_optimizer_state(sd: dict, optimizer, module: nn.Module) -> dict:
    """A whole module's optimizer ``state_dict`` with each per-element state
    tensor cut to this rank's slice (the inverse of
    ``full_optimizer_state``)."""
    layout = layout_of(module)
    if layout is None:
        return sd
    params = _optimizer_params(optimizer)
    state = {}
    for i, s in sd["state"].items():
        p = params[i]
        place, whole = layout.placement_of(p), layout.shapes[id(p)]
        state[i] = {k: layout.shard(v, place) if torch.is_tensor(v)
                    and v.dim() and v.shape == whole else v
                    for k, v in s.items()}
    return {**sd, "state": state}
