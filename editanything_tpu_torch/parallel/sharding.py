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

JAX's tensor-parallel and FSDP layouts (``shard_params_tp``,
``shard_params_fsdp``, ``place_on_mesh``) have no counterpart: they fit a
model into a TPU's memory, and the port's largest training step holds
about a quarter of one card's.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn as nn


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
