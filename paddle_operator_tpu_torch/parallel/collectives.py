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
  and the checkpoint writer (the identity for a group of one);
* the collectives of sequence parallelism, what the reference gets from
  ``lax.ppermute`` and ``lax.all_to_all``, differentiable: :func:`ring_shift`
  (one hop around the ring; its backward is the hop the other way) and
  :func:`all_to_all` (the ``tiled=True`` form; its backward is the
  inverse all-to-all); :func:`sequence_shards` sets the group a loss's
  sequence is split over while the loss runs;
* the collectives of expert parallelism: :func:`expert_shards` sets the
  group a MoE layer's experts are split over, :func:`moe_split` reads
  the whole layout (the token group and this rank's block of it, the
  sequence group, the expert group) for ``ops/moe.py``;
  :func:`sum_forward` (an all-reduce sum whose backward is the identity)
  and :func:`sum_backward` (the identity whose backward is an all-reduce
  sum) are the conjugate pair a layer replicated over a group uses
  around a part each rank computes only a share of; :func:`sum_` and
  :func:`sum_counts` reduce without a gradient;
* the collectives of tensor parallelism (tp, and ResNet's classifier over
  fsdp): :func:`model_tiles` sets the leaves split over a model axis for
  the layers (:class:`Tile`: the group over the leaf's axes and this
  rank's tile), which :func:`moe_split` hands on in :attr:`Split.tiles`;
  a column-parallel layer's input goes through :func:`sum_backward`, a
  row-parallel layer's output through :func:`sum_forward` (Megatron's
  two conjugate operators); :func:`vocab_lookup` is an embedding over a
  vocabulary split by rows, :func:`vocab_xent_pieces` the log-sum-exp,
  the picked logit and the argmax of logits split by columns, and
  :func:`gather_last` joins column tiles with the rank's slice as its
  backward. :data:`tp_traffic` counts their collectives;
* the collectives of pipeline parallelism (:mod:`.pipeline`):
  :func:`pipeline_hop` moves a stage's output to the next stage (the
  reference's ``lax.ppermute``, its backward the hop the other way), the
  output's sum over the stages is :func:`sum_forward` (its backward the
  identity: the output is replicated, and so is its cotangent) and the
  replicated input goes through :func:`sum_backward`;
  :func:`stage_slice` takes a stage's block of a whole stacked leaf, with
  the gather of the blocks' cotangents as its backward.
  :data:`pp_traffic` counts them.

Under a sequence axis each rank's loss and gradients are parts of its
replica's (``shards`` ranks hold the blocks of one sequence), so
:func:`mean_grads` and :func:`mean_metrics` take ``shards``: the mean over
the world times ``shards`` is the sum over each replica's blocks averaged
over the replicas, in one collective whose result is the same on every
rank.

A mean over NCCL is one ``ReduceOp.AVG`` all-reduce (NCCL scales by
``1/size`` before it sums, in the kernel); gloo has no AVG, so there it
is a SUM and a division. For a world of 1, 2 or 4 both give the same
bits: the scale is a power of two. Every function takes the group of a
:class:`.mesh.Mesh`; ``None`` (one process, no group) is the identity.
Every rank must call them in the same order.

Transport of the sequence collectives: NCCL moves CUDA tensors with
``batch_isend_irecv`` and ``all_to_all_single``. gloo's point-to-point
and all-to-all read host memory, so on gloo a CUDA tensor is staged
through a host copy (:func:`_gloo_staged`): that is gloo's transport,
used only for a gloo group, never on NCCL. ``transfers`` counts the
ring's hops and all-to-alls with their bytes and host seconds.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import bridge

Group = Optional[dist.ProcessGroup]

#: the largest flat bucket of :func:`mean_grads` and :func:`broadcast_`
BUCKET_BYTES = 25 * 2**20


def _on_nccl(group: Group) -> bool:
    return dist.get_backend(group) == "nccl"


#: the means over a group since the last reset (the gradient buckets, the
#: metrics, sync BatchNorm's statistics): count, bytes and host seconds
mean_traffic = {"mean": 0, "bytes": 0, "seconds": 0.0}


def mean_(t: torch.Tensor, group: Group, shards: int = 1) -> torch.Tensor:
    """Average ``t`` over ``group`` in place, times ``shards``; returns
    ``t``. Counted in :data:`mean_traffic`."""
    if group is None:
        return t
    t0 = time.perf_counter()
    if _on_nccl(group):
        dist.all_reduce(t, op=dist.ReduceOp.AVG, group=group)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(dist.get_world_size(group))
    if shards != 1:
        t.mul_(shards)
    _count(mean_traffic, "mean", t, t0)
    return t


def host_seconds() -> float:
    """Host seconds this process has spent in the collectives of a train
    step since the traffic counters' last reset: the means, the sequence,
    MoE, tensor- and pipeline-parallel collectives. The runner reads it
    around a step to tell the step's own time from its waits on peers."""
    return sum(d["seconds"] for d in (mean_traffic, transfers, moe_traffic,
                                      tp_traffic, pp_traffic))


def gather_floats(value: float, group: Group) -> List[float]:
    """Every rank's ``value``, in rank order (an all-gather: every rank
    of ``group`` calls it at the same point). On the backend's own
    device: a CUDA tensor on NCCL, a CPU one on gloo."""
    if _alone(group):
        return [float(value)]
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_scalar_device(group))
    out = [torch.empty_like(t) for _ in range(size(group))]
    dist.all_gather(out, t, group=group)
    return [float(x.item()) for x in out]


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


def mean_grads(grads: Any, group: Group, cap: int = BUCKET_BYTES,
               shards: int = 1) -> Any:
    """The gradient tree averaged over ``group`` (times ``shards``, the
    sequence shards of one replica): each bucket of :func:`bucket_plan`
    is concatenated into one flat tensor, reduced in one collective, and
    handed back as views of it. ``None`` leaves stay ``None``."""
    if group is None:
        return grads
    out = bridge.flatten(grads)
    names = [k for k, g in out.items() if g is not None]
    tensors = [out[k] for k in names]
    for idx in bucket_plan(tensors, cap):
        flat = mean_(torch.cat([tensors[i].reshape(-1) for i in idx]), group,
                     shards)
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


def mean_metrics(metrics: Dict[str, Any], group: Group,
                 shards: int = 1) -> Dict[str, Any]:
    """Average every floating tensor of a metrics dict over ``group`` in
    one collective (in fp32; times ``shards``, as :func:`mean_grads`);
    other entries pass through."""
    if group is None:
        return metrics
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not keys:
        return metrics
    flat = mean_(torch.cat([metrics[k].detach().float().reshape(-1)
                            for k in keys]), group, shards)
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
    "batch_group", default=(None, None))


@contextlib.contextmanager
def sync_batch(group: Group, index: Optional[int] = None):
    """While the block runs, :func:`batch_group` is ``group``, the ranks
    that hold distinct tokens of the global batch, and ``index`` this
    rank's block of the batch axis (default: its rank in ``group`` over
    the sequence blocks, :func:`seq_block`): the train step sets them
    around the loss, so that BatchNorm's batch statistics and MoE
    routing span the global batch. They are read in the forward; the
    backward's collectives take the group the forward saved (a recompute
    under remat, in the autograd engine's thread, would not see it)."""
    token = _BATCH_GROUP.set((group, index))
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_group() -> Group:
    """The group the batch is split over, inside :func:`sync_batch`
    (``None`` outside it and without a mesh)."""
    return _BATCH_GROUP.get()[0]


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


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

#: the sequence collectives' traffic since the last reset: ring hops and
#: all-to-alls, their bytes (sent by this rank) and host seconds
transfers = {"ring_shift": 0, "all_to_all": 0, "bytes": 0, "seconds": 0.0}


def _gloo_staged(group: Group, x: torch.Tensor) -> bool:
    """gloo's transport: a CUDA tensor crosses a gloo group through a
    host copy (gloo's point-to-point and all-to-all read host memory)."""
    return x.device.type == "cuda" and not _on_nccl(group)


def _exchange(group: Group, send: torch.Tensor, run,
              traffic: Optional[dict] = None) -> torch.Tensor:
    """``run(host_send, host_recv)`` on ``send`` (contiguous) and a buffer
    of its shape, staged through the host on gloo; returns the received
    tensor on ``send``'s device, and counts the bytes and seconds in
    ``traffic`` (default :data:`transfers`)."""
    traffic = transfers if traffic is None else traffic
    t0 = time.perf_counter()
    staged = _gloo_staged(group, send)
    out = send.to("cpu") if staged else send
    recv = torch.empty_like(out)
    run(out, recv)
    if staged:
        recv = recv.to(send.device)
    traffic["bytes"] += send.numel() * send.element_size()
    traffic["seconds"] += time.perf_counter() - t0
    return recv


def _shift(x: torch.Tensor, group: Group, step: int,
           traffic: Optional[dict] = None,
           kind: str = "ring_shift") -> torch.Tensor:
    """``x`` sent to the rank ``step`` places on around ``group``'s ring,
    and the tensor of the rank ``step`` places back received; counted as
    ``kind`` in ``traffic`` (default :data:`transfers`)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)

    def run(send: torch.Tensor, recv: torch.Tensor) -> None:
        ops = [dist.P2POp(dist.isend, send, dst, group),
               dist.P2POp(dist.irecv, recv, src, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    traffic = transfers if traffic is None else traffic
    traffic[kind] += 1
    return _exchange(group, x.detach().contiguous(), run, traffic)


def _all_to_all(x: torch.Tensor, group: Group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` cut into ``n`` equal
    chunks along ``split_axis``, chunk j sent to rank j, and the chunks
    received from ranks 0..n-1 joined along ``concat_axis``."""
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError("all_to_all: axis %d of %r does not split into %d"
                         % (split_axis, tuple(x.shape), n))
    send = torch.stack(x.detach().chunk(n, dim=split_axis))

    def run(send: torch.Tensor, recv: torch.Tensor) -> None:
        dist.all_to_all_single(recv, send, group=group)

    transfers["all_to_all"] += 1
    recv = _exchange(group, send, run)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _RingShift(torch.autograd.Function):
    """One hop forward around the ring; the backward sends the cotangent
    one hop back (``ppermute`` transposes itself). ``kinds``: the
    counts of the two directions in ``traffic``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Group,
                traffic: Optional[dict], kinds: Tuple[str, str]
                ) -> torch.Tensor:
        ctx.args = (group, traffic, kinds[1])
        return _shift(x, group, 1, traffic, kinds[0])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        group, traffic, kind = ctx.args
        return _shift(grad, group, -1, traffic, kind), None, None, None


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all`; the backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(grad, group, concat_axis, split_axis), None, \
            None, None


def ring_shift(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` of group rank i sent to rank (i + 1) mod n; returns the
    tensor of rank (i - 1) mod n. Differentiable. The identity for a
    group of one."""
    if _alone(group):
        return x
    return _RingShift.apply(x, group, None, ("ring_shift", "ring_shift"))


def all_to_all(x: torch.Tensor, group: Group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The reference's ``lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)`` over ``group``. Differentiable. The identity for a
    group of one."""
    if _alone(group):
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


_SEQ_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "seq_group", default=None)


@contextlib.contextmanager
def sequence_shards(group: Group):
    """While the block runs, the sequence is split over ``group``: the
    train step sets it around the loss under a sequence axis, so that the
    loss takes this rank's block of each sequence (:func:`seq_block`).
    Read it in the forward, outside any recomputed region."""
    token = _SEQ_GROUP.set(group)
    try:
        yield
    finally:
        _SEQ_GROUP.reset(token)


def seq_block() -> tuple:
    """``(index, count)``: this rank's block of the sequence and the
    number of blocks, inside :func:`sequence_shards`; ``(0, 1)`` without
    a sequence split."""
    group = _SEQ_GROUP.get()
    if _alone(group):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

_EXPERT_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "expert_group", default=None)


@contextlib.contextmanager
def expert_shards(group: Group):
    """While the block runs, a MoE layer's experts are split over
    ``group`` (the ep ranks, which hold the same tokens): the train step
    sets it around the loss under an ep axis."""
    token = _EXPERT_GROUP.set(group)
    try:
        yield
    finally:
        _EXPERT_GROUP.reset(token)


class Tile(NamedTuple):
    """A leaf split over model axes (tp, fsdp) as this rank holds it:
    ``group`` the ranks that hold its other tiles (the group over the
    leaf's axes), ``index`` this rank's tile of ``count`` along the one
    dimension the rule splits."""

    group: Group
    index: int
    count: int


_MODEL_TILES: contextvars.ContextVar = contextvars.ContextVar(
    "model_tiles", default=None)


@contextlib.contextmanager
def model_tiles(tiles: Optional[Dict[str, Tile]]):
    """While the block runs, the parameter leaves (paths of
    :func:`..bridge.flatten`) in ``tiles`` are this rank's tiles of
    leaves split over a model axis: the train step sets it around the
    loss, and :func:`moe_split` hands it to every layer. A rule that fell
    back to replicated (a dimension that does not divide) leaves its
    leaf out, so a layer reads the split from here, never from a local
    shape."""
    token = _MODEL_TILES.set(tiles or None)
    try:
        yield
    finally:
        _MODEL_TILES.reset(token)


class Split(NamedTuple):
    """How a layer's tokens, experts and weights lie over the ranks, read
    in the forward and handed to every layer (remat's recompute reruns a
    layer in the autograd engine's thread, where the contexts are not
    set): ``batch`` the ranks holding distinct tokens, ``batch_index``
    this rank's block of the batch axis among them, ``seq`` the ranks
    holding blocks of the same sequences (``seq_index`` this rank's),
    ``expert`` the ranks holding the same tokens and splitting the
    experts, ``tiles`` the leaves split over tp or fsdp
    (:func:`model_tiles`)."""

    batch: Group = None
    batch_index: int = 0
    seq: Group = None
    seq_index: int = 0
    expert: Group = None
    tiles: Optional[Dict[str, Tile]] = None

    @property
    def batch_blocks(self) -> int:
        """Blocks of the batch axis: the token group over the sequence
        blocks."""
        return size(self.batch) // size(self.seq)

    def tile(self, path: str) -> Optional[Tile]:
        """The :class:`Tile` of parameter leaf ``path``, ``None`` when this
        rank holds it whole."""
        return (self.tiles or {}).get(path)


def moe_split() -> Split:
    """The :class:`Split` the contexts of :func:`sync_batch`,
    :func:`sequence_shards`, :func:`expert_shards` and
    :func:`model_tiles` describe (every field empty outside them)."""
    group, index = _BATCH_GROUP.get()
    seq_index, seqs = seq_block()
    if _alone(group):
        group, index = None, 0
    elif index is None:
        index = dist.get_rank(group) // seqs
    expert = _EXPERT_GROUP.get()
    return Split(group, index, None if seqs == 1 else _SEQ_GROUP.get(),
                 seq_index, None if _alone(expert) else expert,
                 _MODEL_TILES.get())


def sum_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` summed over ``group`` in place; returns ``t``."""
    if not _alone(group):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


#: the MoE collectives since the last reset: the routing counts' sums, the
#: ep sums of the forward and of the backward, their bytes and host seconds
moe_traffic = {"routing": 0, "sum_forward": 0, "sum_backward": 0,
               "bytes": 0, "seconds": 0.0}

#: the tensor-parallel collectives since the last reset: the row-parallel
#: and vocabulary sums of the forward, the column-parallel inputs' sums of
#: the backward, the vocabulary max and argmax and the fsdp gathers, their
#: bytes (this rank's send) and host seconds
tp_traffic = {"sum_forward": 0, "sum_backward": 0, "max": 0, "argmax": 0,
              "gather": 0, "bytes": 0, "seconds": 0.0}


def _count(traffic: dict, kind: str, t: torch.Tensor, t0: float) -> None:
    traffic[kind] += 1
    traffic["bytes"] += t.numel() * t.element_size()
    traffic["seconds"] += time.perf_counter() - t0


def _timed_sum(kind: str, t: torch.Tensor, group: Group,
               traffic: Optional[dict] = None) -> torch.Tensor:
    t0 = time.perf_counter()
    sum_(t, group)
    _count(moe_traffic if traffic is None else traffic, kind, t, t0)
    return t


def sum_counts(t: torch.Tensor, group: Group) -> torch.Tensor:
    """MoE routing's integer counts summed over ``group`` (a new tensor
    on ``t``'s device; reduced where ``group``'s backend reduces
    integers), counted in :data:`moe_traffic`."""
    if _alone(group):
        return t
    dev = t.device if _on_nccl(group) and t.device.type == "cuda" \
        else _scalar_device(group)
    return _timed_sum("routing", t.to(dev, copy=True), group).to(t.device)


class _SumForward(torch.autograd.Function):
    """An all-reduce sum over the group; the backward passes the
    cotangent on as it is (each rank already holds the whole one)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Group,
                traffic: Optional[dict]) -> torch.Tensor:
        return _timed_sum("sum_forward", x.contiguous().clone(), group,
                          traffic)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None, None


class _SumBackward(torch.autograd.Function):
    """The identity; the backward sums the cotangent over the group
    (each rank computed the part of it its share reaches)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Group,
                traffic: Optional[dict]) -> torch.Tensor:
        ctx.group, ctx.traffic = group, traffic
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _timed_sum("sum_backward",
                          grad.contiguous().clone(), ctx.group,
                          ctx.traffic), None, None


def sum_forward(x: torch.Tensor, group: Group,
                traffic: Optional[dict] = None) -> torch.Tensor:
    """``x`` summed over ``group``, with the identity as its backward:
    the output of a part each rank computes a share of, consumed by a
    replicated rest (a row-parallel layer's output). Counted in
    ``traffic`` (default :data:`moe_traffic`). The identity for a group
    of one."""
    if _alone(group):
        return x
    return _SumForward.apply(x, group, traffic)


def sum_backward(x: torch.Tensor, group: Group,
                 traffic: Optional[dict] = None) -> torch.Tensor:
    """``x`` as it is, with a sum over ``group`` as its backward: a
    replicated input of a part each rank computes a share of (a
    column-parallel layer's input). Counted in ``traffic`` (default
    :data:`moe_traffic`). The identity for a group of one."""
    if _alone(group):
        return x
    return _SumBackward.apply(x, group, traffic)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, tile: Tile,
                 dtype: torch.dtype) -> torch.Tensor:
    """An embedding lookup when ``table`` is row tile ``tile.index`` of a
    vocabulary split over ``tile.group``: ids outside this rank's rows
    look up nothing (zeros), the rows are cast to ``dtype`` and summed
    over the group. Exact, since one rank contributes each token; the
    backward reaches only this rank's rows."""
    rows = table.shape[0]
    local = ids - tile.index * rows
    inside = (local >= 0) & (local < rows)
    x = table[torch.where(inside, local, 0)].to(dtype) * inside[..., None]
    return sum_forward(x, tile.group, tp_traffic)


def _reduce_no_grad(kind: str, t: torch.Tensor, group: Group,
                    op) -> torch.Tensor:
    t0 = time.perf_counter()
    t = t.detach().contiguous().clone()
    dist.all_reduce(t, op=op, group=group)
    _count(tp_traffic, kind, t, t0)
    return t


def vocab_xent_pieces(logits: torch.Tensor, labels: torch.Tensor,
                      tile: Tile) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """``(lse, picked, argmax)`` of each row of ``[N, V]`` fp32 logits
    whose columns ``logits`` ``[N, V/n]`` are tile ``tile.index`` of
    ``n``: the log-sum-exp (the max over the group without a gradient,
    then the sum of exponentials over it), the logit at each global
    ``labels`` id (from the rank that holds it) and the global argmax
    (ties go to the lowest global index, as ``torch.argmax``'s do). The
    first two are differentiable and the same on every rank; no
    ``[N, V]`` tensor is gathered."""
    group = tile.group
    cols = logits.shape[-1]
    start = tile.index * cols
    top, where = logits.detach().max(dim=-1)
    m = _reduce_no_grad("max", top, group, dist.ReduceOp.MAX)
    sumexp = torch.exp(logits - m[:, None]).sum(dim=-1)
    lse = m + torch.log(sum_forward(sumexp, group, tp_traffic))
    local = labels - start
    inside = (local >= 0) & (local < cols)
    picked = logits.gather(-1, torch.where(inside, local, 0)[:, None])[:, 0]
    picked = sum_forward(picked * inside, group, tp_traffic)
    first = torch.where(top == m, where + start,
                        torch.full_like(where, 2 ** 62))
    argmax = _reduce_no_grad("argmax", first, group, dist.ReduceOp.MIN)
    return lse, picked, argmax


def last_tile(grad: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Tile ``index`` of ``count`` of ``grad``'s last dimension: the
    backward of :func:`gather_last`."""
    return grad.chunk(count, dim=-1)[index].contiguous()


class _GatherLast(torch.autograd.Function):
    """The ranks' tiles joined along the last dimension; the backward is
    this rank's slice of the cotangent (every rank holds the whole one,
    consumed by a replicated rest)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, tile: Tile) -> torch.Tensor:
        ctx.tile = tile
        t0 = time.perf_counter()
        staged = _gloo_staged(tile.group, x)
        send = x.detach().contiguous()
        send = send.cpu() if staged else send
        parts = [torch.empty_like(send) for _ in range(tile.count)]
        dist.all_gather(parts, send, group=tile.group)
        out = torch.cat(parts, dim=-1)
        _count(tp_traffic, "gather", send, t0)
        return out.to(x.device) if staged else out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return last_tile(grad, ctx.tile.index, ctx.tile.count), None


def gather_last(x: torch.Tensor, tile: Tile) -> torch.Tensor:
    """Column tiles ``x`` ``[..., C/n]`` of the ranks of ``tile.group``
    joined into ``[..., C]`` (in tile order), with this rank's slice of
    the cotangent as the backward. The identity for a group of one."""
    if _alone(tile.group):
        return x
    return _GatherLast.apply(x, tile)


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------

#: the pipeline's collectives since the last reset: the stage-to-stage
#: hops of the forward and of the backward, the output's sums over the
#: stages (forward), the input's cotangent sums (backward) and the gathers
#: of a whole stacked tree's gradient, their bytes (this rank's send) and
#: host seconds
pp_traffic = {"hop": 0, "hop_backward": 0, "sum_forward": 0,
              "sum_backward": 0, "gather": 0, "bytes": 0, "seconds": 0.0}


def pipeline_hop(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The pipeline's ``lax.ppermute`` over ``group``: stage i's ``x``
    sent to stage (i + 1) mod n, stage (i - 1) mod n's received; the
    backward sends the cotangent back the other way. Counted in
    :data:`pp_traffic`. The identity for a group of one."""
    if _alone(group):
        return x
    return _RingShift.apply(x, group, pp_traffic, ("hop", "hop_backward"))


class _StageSlice(torch.autograd.Function):
    """Block ``index`` of a leaf stacked over the stages (its leading
    axis of 1 kept); the backward gathers every stage's block of the
    cotangent over the group, so that each rank holds the whole stacked
    leaf's gradient, as the reference's gradient of a sharded array is
    whole."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Group,
                index: int) -> torch.Tensor:
        ctx.group = group
        return x.narrow(0, index, 1).clone()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        t0 = time.perf_counter()
        staged = _gloo_staged(ctx.group, grad)
        send = grad.detach().contiguous()
        send = send.cpu() if staged else send
        parts = [torch.empty_like(send) for _ in range(size(ctx.group))]
        dist.all_gather(parts, send, group=ctx.group)
        out = torch.cat(parts, dim=0)
        _count(pp_traffic, "gather", send, t0)
        return (out.to(grad.device) if staged else out), None, None


def stage_slice(x: torch.Tensor, group: Group, index: int) -> torch.Tensor:
    """``x[index:index + 1]`` of a leaf stacked over the ranks of
    ``group`` (one block a rank), with the gather of the blocks'
    cotangents as its backward. A plain slice for a group of one."""
    if _alone(group):
        return x.narrow(0, index, 1)
    return _StageSlice.apply(x, group, index)
