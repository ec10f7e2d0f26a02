"""The collectives of the data-parallel path: what GSPMD inserts into the
JAX package's dp-sharded train step, written out for
``torch.distributed``.

* :func:`mean_grads`: the gradient mean over the mesh, in flat buckets of
  at most :data:`BUCKET_BYTES` (one collective a bucket; leaves without a
  gradient, such as BatchNorm's running stats, are skipped);
* :func:`broadcast_`: a tree copied from rank 0, in buckets (the state at
  build);
* :func:`mean_metrics`: the loss and scalar metrics averaged in one
  collective, so every rank reports the global batch's value;
* :func:`mean_with_grad`: a mean whose backward is the mean of the
  cotangents, for sync BatchNorm; :func:`sync_batch` sets the group that
  :func:`..ops.nn.batchnorm` reduces over while the loss runs;
* :func:`max_int`, :func:`min_int` and :func:`barrier` for the runner
  and the checkpoint writer (the identity for a group of one).

A mean over NCCL is one ``ReduceOp.AVG`` all-reduce (NCCL scales by
``1/size`` before it sums, in the kernel); gloo has no AVG, so there it
is a SUM and a division. For a world of 1, 2 or 4 both give the same
bits: the scale is a power of two. Every function takes the group of a
:class:`.mesh.Mesh`; ``None`` (one process, no group) is the identity.
Every rank must call them in the same order.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import bridge

Group = Optional[dist.ProcessGroup]

#: the largest flat bucket of :func:`mean_grads` and :func:`broadcast_`
BUCKET_BYTES = 25 * 2**20


def _on_nccl(group: Group) -> bool:
    return dist.get_backend(group) == "nccl"


def mean_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Average ``t`` over ``group`` in place; returns ``t``."""
    if group is None:
        return t
    if _on_nccl(group):
        dist.all_reduce(t, op=dist.ReduceOp.AVG, group=group)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(dist.get_world_size(group))
    return t


def bucket_plan(tensors: Sequence[torch.Tensor],
                cap: int = BUCKET_BYTES) -> List[List[int]]:
    """Indices of ``tensors`` grouped into buckets: runs of consecutive
    tensors of one dtype, at most ``cap`` bytes each (a larger tensor is
    a bucket of its own). One collective a bucket."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    size = 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != tensors[cur[0]].dtype
                    or size + nbytes > cap):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def mean_grads(grads: Any, group: Group, cap: int = BUCKET_BYTES) -> Any:
    """The gradient tree averaged over ``group``: each bucket of
    :func:`bucket_plan` is concatenated into one flat tensor, averaged
    in one collective, and handed back as views of it. ``None`` leaves
    stay ``None``."""
    if group is None:
        return grads
    out = bridge.flatten(grads)
    names = [k for k, g in out.items() if g is not None]
    tensors = [out[k] for k in names]
    for idx in bucket_plan(tensors, cap):
        flat = mean_(torch.cat([tensors[i].reshape(-1) for i in idx]), group)
        pieces = flat.split([tensors[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            out[names[i]] = piece.view(tensors[i].shape)
    return bridge.unflatten(bridge.structure(grads), out)


def broadcast_(tree: Any, group: Group, src: int = 0,
               cap: int = BUCKET_BYTES) -> Any:
    """Copy every tensor leaf of ``tree`` from rank ``src``, in place,
    in buckets. Returns ``tree``."""
    if group is None:
        return tree
    tensors = [t for t in bridge.leaves(tree) if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for idx in bucket_plan(tensors, cap):
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.broadcast(flat, src=src, group=group)
            pieces = flat.split([tensors[i].numel() for i in idx])
            for i, piece in zip(idx, pieces):
                tensors[i].copy_(piece.view(tensors[i].shape))
    return tree


def mean_metrics(metrics: Dict[str, Any], group: Group) -> Dict[str, Any]:
    """Average every floating tensor of a metrics dict over ``group`` in
    one collective (in fp32); other entries pass through."""
    if group is None:
        return metrics
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not keys:
        return metrics
    flat = mean_(torch.cat([metrics[k].detach().float().reshape(-1)
                            for k in keys]), group)
    out = dict(metrics)
    for k, piece in zip(keys, flat.split([metrics[k].numel()
                                          for k in keys])):
        out[k] = piece.view(metrics[k].shape).to(metrics[k].dtype)
    return out


class _MeanWithGrad(torch.autograd.Function):
    """``mean_`` in the forward; the cotangent's mean in the backward
    (the mean over ranks is its own adjoint)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Group) -> torch.Tensor:
        ctx.group = group
        return mean_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return mean_(grad.clone(memory_format=torch.contiguous_format),
                     ctx.group), None


def mean_with_grad(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` averaged over ``group``, differentiable: one collective in
    the forward, one in the backward."""
    if group is None:
        return x
    return _MeanWithGrad.apply(x, group)


_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "batch_group", default=None)


@contextlib.contextmanager
def sync_batch(group: Group):
    """While the block runs, :func:`batch_group` is ``group``: the train
    step sets it around the loss, so that BatchNorm's batch statistics
    span the global batch. It is read in the forward; the backward's
    collectives take the group the forward saved (a recompute under
    remat, in the autograd engine's thread, would not see it)."""
    token = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_group() -> Group:
    """The group the batch is split over, inside :func:`sync_batch`
    (``None`` outside it and without a mesh)."""
    return _BATCH_GROUP.get()


def _scalar_device(group: Group) -> torch.device:
    """Where a small control tensor lives for ``group``'s backend: NCCL
    reduces only CUDA tensors, gloo reads CPU tensors without staging."""
    if _on_nccl(group):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def size(group: Group) -> int:
    """The ranks of ``group`` (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


def _alone(group: Group) -> bool:
    return size(group) == 1


def _reduce_int(value: int, group: Group, op) -> int:
    if _alone(group):
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_scalar_device(group))
    dist.all_reduce(t, op=op, group=group)
    return int(t.item())


def max_int(value: int, group: Group) -> int:
    """The largest of every rank's ``value``."""
    return _reduce_int(value, group, dist.ReduceOp.MAX)


def min_int(value: int, group: Group) -> int:
    """The smallest of every rank's ``value``."""
    return _reduce_int(value, group, dist.ReduceOp.MIN)


def barrier(group: Group) -> None:
    """Every rank of ``group`` reaches this point before any leaves it."""
    if not _alone(group):
        dist.barrier(group=group)
