"""The train step: the port of ``paddle_operator_tpu/parallel/train.py``'s
``build_train_step``, on one device or data-parallel over a ``dp`` mesh of
processes (:mod:`.mesh`).

``step_fn(state, batch) -> (state, metrics)`` computes the loss and its
grads with autograd, optionally clips them, applies the optimizer and then
folds BatchNorm running stats into the params (``merge_stats``, AFTER the
update, as the reference does). The state is updated in place, the
counterpart of the JAX step's ``donate_argnums=0``: ``state`` holds one
copy of params and optimizer state for the run.

Under a dp mesh each rank runs this step on its block of the global
batch, and the collectives GSPMD inserts into the reference's program
are written out (:mod:`.collectives`): BatchNorm averages its batch
statistics over the ranks while the loss runs (sync BatchNorm); the
gradients are averaged once an optimizer step, after the last
microbatch and before clipping, so the clip sees the global gradient's
norm; the loss and metrics are averaged so every rank reports the
global batch's. The state is broadcast from rank 0 at build, and stays
identical on every rank from then on.

Under an ``ep`` axis (expert parallelism, ``rules`` with ``moe_rules``)
the leaves the rules split over ``ep`` (:func:`expert_layout`: the
expert weights and their optimizer state) hold this rank's block of
their leading axis from the build on; every other leaf is replicated.
The batch is split over dp only, as the reference's ``batch_spec``
splits it: the ep ranks hold the same tokens, and each MoE layer runs
its local experts and sums the outputs over ep (``ops/moe.py``). The
replicated leaves' gradients take the world mean as before; an expert
leaf's is averaged over the ranks that hold the same shard (every axis
but ep), and the clip's global norm adds the expert leaves' squares
summed over ep, so every rank clips by the same norm. Rules over any
other axis of the mesh raise (ROADMAP A9).

Under ``seq_axis`` (sequence parallelism over a ``dp`` x ``sp`` mesh) the
batch is split over the batch axis only: a rank's block is its dp block
with the token axis whole, and the sp group reaches the loss through
:func:`.collectives.sequence_shards`, so that the loss takes this rank's
block of each sequence and returns its part of the replica's loss. The
gradients, the loss and the metrics are then summed over sp (the blocks
of one replica) and averaged over dp, in one collective over the world
(:func:`_reduce_grads`), so every rank gets the same bits.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Set, Tuple

import torch
import torch.distributed as dist

from .. import bridge
from ..data import process_shard
from ..ops.optim import Optimizer, clip_by_global_norm, global_norm
from . import collectives, sharding
from .mesh import Mesh

#: the mesh axis whose rules the port honours: expert parallelism
EXPERT_AXIS = "ep"


def _grads_of(loss_fn: Callable, params: Any, batch: Any):
    """((loss, aux), grads): grads in the params' tree, ``None`` for a
    leaf the loss does not reach (BN running stats in train mode)."""
    flat = bridge.flatten(params)
    names = [k for k, t in flat.items() if t.is_floating_point()]
    views = {k: t.detach().requires_grad_(k in names)
             for k, t in flat.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(bridge.unflatten(bridge.structure(params), views),
                            batch)
        got = torch.autograd.grad(loss, [views[k] for k in names],
                                  allow_unused=True)
    grads = dict.fromkeys(flat)
    grads.update(zip(names, got))
    return (loss.detach(), aux), bridge.unflatten(bridge.structure(params),
                                                  grads)


def _detach(tree: Any) -> Any:
    return bridge.tree_map(
        lambda t: t.detach() if isinstance(t, torch.Tensor) else t, tree)


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    return a if b is None else a + b


def batch_axis_of(accum_steps: int = 1, steps_per_call: int = 1) -> int:
    """The axis of a batch leaf that the dp mesh splits, the meaning of
    the reference's ``batch_shardings``: 0 for a plain batch, 1 under a
    ``[K]`` window or an ``[accum]`` microbatch stack, 2 under both."""
    return int(accum_steps > 1) + int(steps_per_call > 1)


def _check_mesh(mesh: Mesh, rules: Any, batch_axis: str,
                seq_axis: Optional[str]) -> None:
    """Refuse what the port cannot shard: a sequence axis or a batch axis
    the mesh lacks, and rules that name an axis of the mesh other than
    ``ep``, or ``ep`` on another than a leaf's leading axis. Rules whose
    axes are all missing from the mesh mean "replicated", as the
    reference's rule tables do there."""
    if seq_axis is not None and seq_axis not in mesh.shape:
        raise NotImplementedError(
            "seq_axis=%r is not an axis of the mesh %s: sequence "
            "parallelism splits the sequence over an sp axis of the mesh "
            "(ROADMAP A9 holds the others)" % (seq_axis, mesh.shape))
    if batch_axis not in mesh.shape:
        raise ValueError("batch axis %r is not an axis of the mesh %s"
                         % (batch_axis, mesh.shape))
    for pattern, spec in rules or ():
        for dim, axis in enumerate(spec):
            names = axis if isinstance(axis, tuple) else (axis,)
            for name in names:
                if name is None or name not in mesh.shape:
                    continue
                if name != EXPERT_AXIS:
                    raise NotImplementedError(
                        "sharding rule %r shards over mesh axis %r; the "
                        "port shards parameters over ep only (ROADMAP A9)"
                        % (pattern, name))
                if dim != 0:
                    raise NotImplementedError(
                        "sharding rule %r splits dimension %d over ep; the "
                        "port splits a leaf's leading (expert) axis only"
                        % (pattern, dim))


def expert_layout(params: Any, optimizer: Optimizer,
                  mesh: Optional[Mesh], rules: Any, local: bool = False
                  ) -> Dict[str, Tuple[int, int]]:
    """``{state leaf path: (this rank's ep index, ep size)}`` for the
    leaves of the train state ``{"params", "opt"}`` that ``rules`` split
    over ``ep`` on ``mesh``: the reference's ``shard_tree`` choice on the
    parameters and, separately, on the optimizer state's shapes (made on
    the meta device). ``local``: ``params`` are a live state's, the
    expert leaves already this rank's blocks. Empty without an ep axis
    above 1."""
    if mesh is None or not rules or mesh.axis_size(EXPERT_AXIS) == 1:
        return {}
    where = (mesh.axis_rank(EXPERT_AXIS), mesh.axis_size(EXPERT_AXIS))

    def splits(spec) -> bool:
        return spec is not None and EXPERT_AXIS in sharding.split_axes(
            spec).get(0, ())

    def whole(path: str, p: torch.Tensor) -> torch.Tensor:
        shape = tuple(p.shape)
        if local and splits(sharding.rule_spec(path, rules, mesh.shape)):
            shape = (shape[0] * where[1],) + shape[1:]
        return torch.empty(shape, dtype=p.dtype, device="meta")

    flat = bridge.flatten(params)
    meta = bridge.unflatten(bridge.structure(params),
                            {k: whole(k, p) for k, p in flat.items()})
    specs = {"params/" + k: v for k, v in
             sharding.shard_tree(meta, mesh.shape, rules).items()}
    specs.update({"opt/" + k: v for k, v in sharding.shard_tree(
        optimizer.init(meta), mesh.shape, rules).items()})
    return {path: where for path, spec in specs.items() if splits(spec)}


def local_block(t: torch.Tensor, where: Tuple[int, int]) -> torch.Tensor:
    """Block ``index`` of ``count`` of ``t``'s leading axis (a view)."""
    index, count = where
    n = t.shape[0] // count
    return t[index * n:(index + 1) * n]


def _part(tree: Any, keep: Callable[[str], bool]) -> Any:
    """``tree`` with the leaves whose path ``keep`` refuses set to
    ``None``."""
    flat = bridge.flatten(tree)
    return bridge.unflatten(bridge.structure(tree), {
        k: (v if keep(k) else None) for k, v in flat.items()})


def _beside_ep(mesh: Mesh):
    """The group along every axis but ep: the ranks that hold distinct
    tokens, and the ranks that hold the same expert shard. Without an ep
    axis it is the mesh's own group, also in a world of one (sync
    BatchNorm then launches its collectives, as train_dp counts them)."""
    if mesh.axis_size(EXPERT_AXIS) == 1:
        return mesh.group
    return mesh.group_over([a for a in mesh.shape if a != EXPERT_AXIS])


def _merge(a: Any, b: Any) -> Any:
    """Two trees of one structure, each leaf from whichever holds it."""
    fa, fb = bridge.flatten(a), bridge.flatten(b)
    return bridge.unflatten(bridge.structure(a), {
        k: (v if v is not None else fb[k]) for k, v in fa.items()})


def _reduce_grads(grads: Any, mesh: Optional[Mesh], shards: int) -> Any:
    """The gradients summed over each replica's ``shards`` sequence
    blocks and averaged over the replicas: one mean over the world, times
    ``shards``."""
    return collectives.mean_grads(
        grads, mesh.group if mesh is not None else None, shards=shards)


def reduce_step_grads(grads: Any, mesh: Optional[Mesh], shards: int,
                      expert: Set[str] = frozenset()) -> Any:
    """A rank's gradients reduced as the train step reduces them: the
    replicated leaves by :func:`_reduce_grads` (the world mean times
    ``shards``), the ``expert`` leaves (paths in the gradient tree) by
    the mean over the ranks that hold the same shard, times ``shards``."""
    if not expert:
        return _reduce_grads(grads, mesh, shards)
    local = collectives.mean_grads(_part(grads, expert.__contains__),
                                   _beside_ep(mesh), shards=shards)
    return _merge(_reduce_grads(_part(grads, lambda k: k not in expert),
                                mesh, shards), local)


def _global_norm(grads: Any, expert: Set[str], group) -> torch.Tensor:
    """The whole gradient's global norm when ``grads`` holds this rank's
    shard of the ``expert`` leaves (paths in the gradient tree): the
    replicated leaves' squares once, the expert leaves' squares summed
    over the ep ``group``."""
    sq = {True: [], False: []}
    for k, g in bridge.flatten(grads).items():
        if g is not None:
            sq[k in expert].append(torch.sum(torch.square(g.float())))
    local = torch.stack(sq[True]).sum()
    total = torch.stack(sq[False]).sum() if sq[False] else 0.0
    return torch.sqrt(total + collectives.sum_(local, group))


def shard_contexts(mesh: Optional[Mesh], batch_axis: str = "dp",
                   seq_axis: Optional[str] = None):
    """The contexts the loss runs in on ``mesh``: the token group (every
    axis but ep) and this rank's batch block (:func:`.collectives.
    sync_batch`), the sequence group (:func:`.collectives.
    sequence_shards`) and the expert group (:func:`.collectives.
    expert_shards`). No mesh: none."""
    stack = contextlib.ExitStack()
    if mesh is None:
        return stack
    stack.enter_context(collectives.sync_batch(
        _beside_ep(mesh), mesh.axis_rank(batch_axis)))
    stack.enter_context(collectives.sequence_shards(
        mesh.axis_group(seq_axis) if seq_axis is not None else None))
    stack.enter_context(collectives.expert_shards(
        mesh.axis_group(EXPERT_AXIS)))
    return stack


def build_train_step(loss_fn: Callable, optimizer: Optimizer, params: Any,
                     sample_batch: Any, mesh: Optional[Mesh] = None,
                     rules: Any = None, batch_axis: str = "dp",
                     seq_axis: Optional[str] = None,
                     merge_stats: Optional[Callable] = None,
                     grad_clip: Optional[float] = None,
                     accum_steps: int = 1, steps_per_call: int = 1,
                     init_state: bool = True,
                     host_local_batches: bool = False):
    """Returns ``(step_fn, state)``.

    * ``loss_fn(params, batch) -> (loss, aux)``; if ``merge_stats`` is
      given, ``aux["stats"]`` is folded into params after the update.
    * state = ``{"params", "opt"}``, built from a copy of ``params`` (the
      caller's tree is not touched); ``step_fn`` updates it in place.
    * ``accum_steps > 1``: batch leaves carry a leading microbatch axis;
      grads, loss and aux are averaged over it, and the BN stats of the
      LAST microbatch win (running stats are not additive).
    * ``steps_per_call > 1``: K optimizer steps per call. Leaves with an
      extra leading ``[K]`` axis are sliced one step at a time; leaves of
      the sample's shape are reused every step. Metrics come back stacked
      ``[K]``.
    * ``mesh``: a dp or dp x sp :class:`.mesh.Mesh`.
      ``host_local_batches=False``: ``step_fn`` takes the GLOBAL batch,
      the same on every rank, and each rank trains on its contiguous
      block of the batch axis (:func:`batch_axis_of`), cut by its dp
      index; ``True``: ``step_fn`` takes this rank's block as it is (its
      dp block, the token axis whole under ``seq_axis``). ``rules``
      naming only axes the mesh lacks are accepted (replicated), rules
      over ``ep`` shard the expert leaves, other rules raise.
    * ``seq_axis``: the mesh axis the sequence is split over (``"sp"``):
      the loss runs inside :func:`.collectives.sequence_shards` of that
      axis's group and returns this rank's part of the replica's loss
      (``models.gpt.loss_fn`` does); the gradients, loss and metrics are
      summed over it.
    * ``rules``: ``(regex, spec)`` pairs (:mod:`.sharding`); on a mesh
      with an ``ep`` axis the leaves they split over ep hold this rank's
      block (:func:`expert_layout`), from ``params`` as every rank has it
      whole. ``params`` passed with ``init_state=False`` are the live
      state's (already local).
    """
    group, shards = None, 1
    expert: Dict[str, Tuple[int, int]] = {}
    if mesh is not None:
        _check_mesh(mesh, rules, batch_axis, seq_axis)
        group = mesh.group
        if seq_axis is not None:
            shards = mesh.axis_size(seq_axis)
        expert = expert_layout(params, optimizer, mesh, rules,
                               local=not init_state)
    # gradient-tree paths of the expert leaves
    expert_grads = {k[len("params/"):] for k in expert
                    if k.startswith("params/")}
    # the per-step batch's axis that the mesh splits (the [K] axis is
    # sliced off before step() sees the batch)
    split_axis = batch_axis_of(accum_steps)
    take_block = mesh is not None and not host_local_batches \
        and mesh.axis_size(batch_axis) > 1

    def grads_of(p: Any, batch: Any):
        if accum_steps == 1:
            return _grads_of(loss_fn, p, batch)
        gsum, lsum, aux_c = None, 0.0, None
        for i in range(accum_steps):
            mb = bridge.tree_map(lambda x: x[i], batch)
            (loss, aux), grads = _grads_of(loss_fn, p, mb)
            gsum = grads if gsum is None else bridge.tree_map(_add, gsum,
                                                              grads)
            lsum = lsum + loss
            if isinstance(aux, dict):
                aux_c = {k: (v if k == "stats" or aux_c is None
                             else bridge.tree_map(_add, aux_c[k], v))
                         for k, v in aux.items()}
            else:
                aux_c = aux if aux_c is None else bridge.tree_map(
                    _add, aux_c, aux)
        grads = bridge.tree_map(lambda g: g / accum_steps, gsum)
        if isinstance(aux_c, dict):
            aux = {k: (v if k == "stats" else bridge.tree_map(
                       lambda x: x / accum_steps, v))
                   for k, v in aux_c.items()}
        else:
            aux = bridge.tree_map(lambda x: x / accum_steps, aux_c)
        return (lsum / accum_steps, aux), grads

    def step(state: Dict, batch: Any):
        if take_block:
            batch = process_shard(batch, mesh.axis_rank(batch_axis),
                                  mesh.axis_size(batch_axis),
                                  axis=split_axis)
        with shard_contexts(mesh, batch_axis, seq_axis):
            (loss, aux), grads = grads_of(state["params"], batch)
        grads = reduce_step_grads(grads, mesh, shards, expert_grads)
        gnorm = None
        if grad_clip:
            norm = _global_norm(grads, expert_grads, mesh.axis_group(
                EXPERT_AXIS)) if expert_grads else global_norm(grads)
            grads, gnorm = clip_by_global_norm(grads, grad_clip, norm)
        optimizer.update(grads, state["opt"], state["params"])
        if merge_stats is not None and isinstance(aux, dict) \
                and "stats" in aux:
            merge_stats(state["params"], aux["stats"])
            aux = {k: v for k, v in aux.items() if k != "stats"}
        metrics = {"loss": loss}
        if isinstance(aux, dict):
            metrics.update(_detach(aux))
        metrics = collectives.mean_metrics(metrics, group, shards)
        if gnorm is not None:
            metrics["grad_norm"] = gnorm
        return state, metrics

    sample_ndims = [getattr(x, "ndim", 0)
                    for x in bridge.leaves(sample_batch)]

    def multi_step(state: Dict, batch: Any):
        flat = bridge.flatten(batch)
        windowed = {k for (k, x), nd in zip(flat.items(), sample_ndims)
                    if getattr(x, "ndim", 0) == nd + 1}
        shape = bridge.structure(batch)
        per_step = []
        for i in range(steps_per_call):
            cur = {k: (x[i] if k in windowed else x) for k, x in flat.items()}
            state, metrics = step(state, bridge.unflatten(shape, cur))
            per_step.append(metrics)
        stacked = {k: torch.stack([m[k] for m in per_step])
                   for k in per_step[0]}
        return state, stacked

    step_fn = multi_step if steps_per_call > 1 else step
    step_fn.expert_layout = expert
    if not init_state:
        return step_fn, None
    flat = bridge.flatten(params)
    own = bridge.unflatten(bridge.structure(params), {
        k: (local_block(p, expert["params/" + k]) if "params/" + k in expert
            else p).detach().clone() for k, p in flat.items()})
    state = {"params": own, "opt": optimizer.init(own)}
    if not expert:
        return step_fn, collectives.broadcast_(state, group)
    replicas = _beside_ep(mesh)
    collectives.broadcast_(_part(state, lambda k: k not in expert), group)
    collectives.broadcast_(
        _part(state, expert.__contains__), replicas,
        src=dist.get_global_rank(replicas, 0) if replicas is not None else 0)
    return step_fn, state
