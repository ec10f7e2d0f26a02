"""The train step: the port of ``paddle_operator_tpu/parallel/train.py``'s
``build_train_step``, on one device or over a mesh of processes
(:mod:`.mesh`).

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

Under the model axes ``ep``, ``tp`` and ``fsdp`` (``rules`` such as
``moe_rules``, ``gpt_rules``, ``bert_rules`` or ``resnet_rules``) each
leaf the rules split holds this rank's tile from the build on, on
whatever dimension the rule splits (:func:`layout`: the reference's
``shard_tree`` choice on the parameters and on the optimizer state, and
:func:`.sharding.tile_of`); every other leaf is replicated. The batch is
split over dp only, as the reference's ``batch_spec`` splits it: the
ranks along a model axis hold the same tokens (the same images under
fsdp), so the token group of sync BatchNorm, BERT's mask count and MoE
routing leaves the model axes out. The layers compute on their tiles and
write out the collectives GSPMD inserts into the reference's program: a
MoE layer sums its local experts over ep; a column-parallel layer's
input sums its gradient over tp, and a row-parallel layer's output its
partial products; the vocabulary is split by rows and by columns;
ResNet's classifier is gathered over fsdp. The layers read the split
leaves from :func:`.collectives.model_tiles`. The replicated leaves'
gradients take the world mean as before; a split leaf's is averaged
over the ranks that hold the same tile (every axis but its own), and
the clip's global norm adds each split leaf's squares summed over its
axes, so every rank clips by the same norm.

The model axes combine with each other and with sp: on ``{"tp": 2,
"sp": 2, "ep": 2}`` (the reference's dry-run mesh) attention runs on a
tp rank's heads over the sp ring or Ulysses, and a MoE layer, whose
leaves no tp rule splits, runs whole on every tp rank, routing over the
ranks that hold distinct tokens (dp x sp) and splitting its experts over
ep. The reductions above hold there unchanged: a replicated leaf (a
LayerNorm, a row-parallel bias) is summed over sp and averaged over the
rest, a tile over the ranks along every axis but its own, and the
global norm counts each tile's squares over its own axes (tp tiles over
tp, ep tiles over ep). What the port does not hold raises
``NotImplementedError``: a ``pp`` axis above 1 (the train step does not
pipeline; :func:`.pipeline.pipeline_apply` runs a stack of stages over
it), rules over another axis, and rules over tp or fsdp that no layer
computes on (the CTR tables, ROADMAP A5.4).

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

#: the mesh axis of expert parallelism
EXPERT_AXIS = "ep"
#: the mesh axes the rules split parameter leaves over; the ranks along
#: them hold the same tokens
MODEL_AXES = ("ep", "tp", "fsdp")
#: the rules over tp and fsdp the models' layers compute on: the
#: reference's GPT, BERT and ResNet tables (a rule over those axes outside
#: them, such as ``ctr_rules``, would leave a tile no layer reads)
HONOURED_RULES = frozenset(
    (rx, tuple(spec)) for rx, spec in sharding.gpt_rules()
    + sharding.bert_rules() + sharding.resnet_rules())


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
    the mesh lacks; a ``pp`` axis above 1 (the reference's step only
    replicates over it; :func:`.pipeline.pipeline_apply` is how the port
    uses the axis); rules that split over an axis of the mesh other than
    the model axes, ``ep`` on another than a leaf's leading axis, and
    rules over tp or fsdp outside :data:`HONOURED_RULES`. Rules whose
    axes are all missing from the mesh mean "replicated", as the
    reference's rule tables do there."""
    if seq_axis is not None and seq_axis not in mesh.shape:
        raise NotImplementedError(
            "seq_axis=%r is not an axis of the mesh %s: sequence "
            "parallelism splits the sequence over an sp axis of the mesh"
            % (seq_axis, mesh.shape))
    if mesh.axis_size("pp") > 1:
        raise NotImplementedError(
            "mesh %s: the train step does not pipeline over pp; run the "
            "stages through parallel.pipeline.pipeline_apply (GPipe over "
            "the pp axis) in the loss" % (mesh.shape,))
    if batch_axis not in mesh.shape and any(
            a not in MODEL_AXES + (seq_axis,) for a in mesh.shape):
        # a mesh of model axes and the sequence axis alone (``{"tp": 4}``,
        # ``{"tp": 2, "sp": 2}``) splits no batch
        raise ValueError("batch axis %r is not an axis of the mesh %s"
                         % (batch_axis, mesh.shape))
    for pattern, spec in rules or ():
        for dim, axis in enumerate(spec):
            names = axis if isinstance(axis, tuple) else (axis,)
            for name in names:
                if name is None or mesh.axis_size(name) == 1:
                    continue
                if name not in MODEL_AXES:
                    raise NotImplementedError(
                        "sharding rule %r splits over mesh axis %r; the port "
                        "splits parameters over %s only (ROADMAP A5)"
                        % (pattern, name, ", ".join(MODEL_AXES)))
                if name == EXPERT_AXIS and dim != 0:
                    raise NotImplementedError(
                        "sharding rule %r splits dimension %d over ep; the "
                        "port splits a leaf's leading (expert) axis only "
                        "(ROADMAP A5)" % (pattern, dim))
                if name != EXPERT_AXIS and (
                        pattern, tuple(spec)) not in HONOURED_RULES:
                    raise NotImplementedError(
                        "sharding rule %r over %r: no layer of the port "
                        "computes on such a tile (ROADMAP A5.4)"
                        % (pattern, name))


def layout(params: Any, optimizer: Optimizer, mesh: Optional[Mesh],
           rules: Any, local: bool = False) -> Dict[str, sharding.LeafTile]:
    """``{state leaf path: LeafTile}`` for the leaves of the train state
    ``{"params", "opt"}`` that ``rules`` split over axes of ``mesh`` of
    size above 1: the reference's ``shard_tree`` choice on the parameters
    and, separately, on the optimizer state's shapes (made on the meta
    device), and this rank's block of each split dimension
    (:func:`.sharding.tile_of`). ``local``: ``params`` are a live state's
    on a mesh whose model axis is ep alone, and a leaf counts as split
    when its rule fits the shape its tile makes (an ep rule splits the
    leading expert axis, whose whole size its tile reads back). Under tp
    or fsdp a leaf whose rule fell back can have the shape of a tile
    (BERT-base's 30522-row table at tp 4 reads as 122088 rows, which
    divide by 4): there ``local`` raises, and the build's layout
    (``step_fn.layout``) is what tells. Empty without a model axis above
    1."""
    if mesh is None or not rules or all(
            mesh.axis_size(a) == 1 for a in MODEL_AXES):
        return {}
    if local and any(mesh.axis_size(a) > 1 for a in ("tp", "fsdp")):
        raise ValueError(
            "the layout of a live state on mesh %s cannot be read from its "
            "shapes: a leaf whose tp or fsdp rule fell back looks like a "
            "tile; pass the build's layout (step_fn.layout)" % (mesh.shape,))
    coords = mesh.coords()

    def whole(path: str, p: torch.Tensor) -> torch.Tensor:
        shape = list(p.shape)
        spec = sharding.rule_spec(path, rules, mesh.shape)
        if local and spec is not None:
            for dim, (_, n) in sharding.tile_of(spec, mesh.shape,
                                                coords).items():
                if dim < len(shape):
                    shape[dim] *= n
        return torch.empty(shape, dtype=p.dtype, device="meta")

    flat = bridge.flatten(params)
    meta = bridge.unflatten(bridge.structure(params),
                            {k: whole(k, p) for k, p in flat.items()})
    specs = {"params/" + k: v for k, v in
             sharding.shard_tree(meta, mesh.shape, rules).items()}
    specs.update({"opt/" + k: v for k, v in sharding.shard_tree(
        optimizer.init(meta), mesh.shape, rules).items()})
    out = {}
    for path, spec in specs.items():
        blocks = sharding.tile_of(spec, mesh.shape, coords)
        if blocks:
            axes = sharding.split_axes(spec)
            out[path] = sharding.LeafTile(blocks, tuple(sorted(
                {a for d in blocks for a in axes[d]
                 if mesh.axis_size(a) > 1})))
    return out


def local_block(t: torch.Tensor, tile: sharding.LeafTile) -> torch.Tensor:
    """This rank's tile of ``t`` (a view)."""
    return sharding.cut(t, tile.blocks)


def _part(tree: Any, keep: Callable[[str], bool]) -> Any:
    """``tree`` with the leaves whose path ``keep`` refuses set to
    ``None``."""
    flat = bridge.flatten(tree)
    return bridge.unflatten(bridge.structure(tree), {
        k: (v if keep(k) else None) for k, v in flat.items()})


def token_group(mesh: Mesh):
    """The group along every axis but the model axes (ep, tp, fsdp): the
    ranks that hold distinct tokens. Without a model axis above 1 it is
    the mesh's own group, also in a world of one (sync BatchNorm then
    launches its collectives, as train_dp counts them)."""
    if all(mesh.axis_size(a) == 1 for a in MODEL_AXES):
        return mesh.group
    return mesh.group_over([a for a in mesh.shape if a not in MODEL_AXES])


def replica_group(mesh: Mesh, axes):
    """The ranks that hold the same tile of a leaf split over ``axes``:
    the group along every other axis (``None`` when this rank is
    alone)."""
    return mesh.group_over([a for a in mesh.shape if a not in axes])


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


def _by_axes(split: Dict[str, Tuple[str, ...]]) -> Dict[tuple, Set[str]]:
    out: Dict[tuple, Set[str]] = {}
    for k, axes in split.items():
        out.setdefault(tuple(axes), set()).add(k)
    return out


def reduce_step_grads(grads: Any, mesh: Optional[Mesh], shards: int,
                      split: Optional[Dict[str, Tuple[str, ...]]] = None
                      ) -> Any:
    """A rank's gradients reduced as the train step reduces them: the
    replicated leaves by :func:`_reduce_grads` (the world mean times
    ``shards``), each ``split`` leaf (gradient-tree path -> the axes it
    is split over) by the mean over the ranks that hold the same tile,
    times ``shards`` (one collective a bucket of each axis set)."""
    if not split:
        return _reduce_grads(grads, mesh, shards)
    out = _reduce_grads(_part(grads, lambda k: k not in split), mesh,
                        shards)
    for axes, paths in sorted(_by_axes(split).items()):
        out = _merge(out, collectives.mean_grads(
            _part(grads, paths.__contains__), replica_group(mesh, axes),
            shards=shards))
    return out


def _global_norm(grads: Any, groups: Dict[str, Any]) -> torch.Tensor:
    """The whole gradient's global norm when ``grads`` holds this rank's
    tiles of the split leaves (``groups``: gradient-tree path -> the
    group over the leaf's axes): the replicated leaves' squares once,
    each split leaf's squares summed over its group (one sum a group)."""
    rep: list = []
    parts: Dict[int, list] = {}
    for k, g in bridge.flatten(grads).items():
        if g is None:
            continue
        sq = torch.sum(torch.square(g.float()))
        if k in groups:
            parts.setdefault(id(groups[k]), [groups[k], []])[1].append(sq)
        else:
            rep.append(sq)
    total = torch.stack(rep).sum() if rep else 0.0
    for group, sqs in parts.values():
        total = total + collectives.sum_(torch.stack(sqs).sum(), group)
    return torch.sqrt(total)


def model_tiles(mesh: Mesh, tiles: Dict[str, sharding.LeafTile]
                ) -> Dict[str, collectives.Tile]:
    """The layers' view of the parameter leaves split over tp or fsdp
    (ep leaves reach the MoE layers through the expert group):
    ``{param path: collectives.Tile}``, each with the group over its axes
    and its block of the one dimension its rule splits."""
    out = {}
    for path, t in tiles.items():
        if not path.startswith("params/") or EXPERT_AXIS in t.axes:
            continue
        if len(t.blocks) != 1:
            raise NotImplementedError(
                "leaf %r is split on %d dimensions; the layers compute on "
                "tiles of one" % (path, len(t.blocks)))
        (index, count), = t.blocks.values()
        out[path[len("params/"):]] = collectives.Tile(
            mesh.group_over(t.axes), index, count)
    return out


def shard_contexts(mesh: Optional[Mesh], batch_axis: str = "dp",
                   seq_axis: Optional[str] = None,
                   tiles: Optional[Dict[str, collectives.Tile]] = None):
    """The contexts the loss runs in on ``mesh``: the token group (every
    axis but the model axes) and this rank's batch block
    (:func:`.collectives.sync_batch`), the sequence group
    (:func:`.collectives.sequence_shards`), the expert group
    (:func:`.collectives.expert_shards`) and the leaves split over tp or
    fsdp (``tiles``, :func:`model_tiles`: :func:`.collectives.
    model_tiles`). No mesh: none."""
    stack = contextlib.ExitStack()
    if mesh is None:
        return stack
    stack.enter_context(collectives.sync_batch(
        token_group(mesh), mesh.axis_rank(batch_axis)))
    stack.enter_context(collectives.sequence_shards(
        mesh.axis_group(seq_axis) if seq_axis is not None else None))
    stack.enter_context(collectives.expert_shards(
        mesh.axis_group(EXPERT_AXIS)))
    stack.enter_context(collectives.model_tiles(tiles))
    return stack


def build_train_step(loss_fn: Callable, optimizer: Optimizer, params: Any,
                     sample_batch: Any, mesh: Optional[Mesh] = None,
                     rules: Any = None, batch_axis: str = "dp",
                     seq_axis: Optional[str] = None,
                     merge_stats: Optional[Callable] = None,
                     grad_clip: Optional[float] = None,
                     accum_steps: int = 1, steps_per_call: int = 1,
                     init_state: bool = True,
                     host_local_batches: bool = False,
                     tiles: Optional[Dict[str, sharding.LeafTile]] = None):
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
    * ``mesh``: a :class:`.mesh.Mesh` over dp, sp, ep, tp and fsdp, in
      any combination (a ``pp`` axis of size 1).
      ``host_local_batches=False``: ``step_fn`` takes the GLOBAL batch,
      the same on every rank, and each rank trains on its contiguous
      block of the batch axis (:func:`batch_axis_of`), cut by its dp
      index; ``True``: ``step_fn`` takes this rank's block as it is (its
      dp block, the token axis whole under ``seq_axis``).
    * ``seq_axis``: the mesh axis the sequence is split over (``"sp"``):
      the loss runs inside :func:`.collectives.sequence_shards` of that
      axis's group and returns this rank's part of the replica's loss
      (``models.gpt.loss_fn`` does); the gradients, loss and metrics are
      summed over it.
    * ``rules``: ``(regex, spec)`` pairs (:mod:`.sharding`); rules naming
      only axes the mesh lacks are accepted (replicated). On a mesh with
      a model axis the leaves they split hold this rank's tile
      (:func:`layout`, ``step_fn.layout``), cut from ``params`` as every
      rank has them whole. ``params`` passed with ``init_state=False``
      are the live state's (already tiles): pass the build's layout as
      ``tiles``; under tp or fsdp it is required (:func:`layout`'s
      ``local`` reads it from their shapes under ep alone).
    """
    group, shards = None, 1
    tiles_of: Dict[str, sharding.LeafTile] = {}
    if mesh is not None:
        _check_mesh(mesh, rules, batch_axis, seq_axis)
        group = mesh.group
        if seq_axis is not None:
            shards = mesh.axis_size(seq_axis)
        tiles_of = tiles if tiles is not None else layout(
            params, optimizer, mesh, rules, local=not init_state)
    # gradient-tree paths of the split leaves: their axes, their groups
    split = {k[len("params/"):]: t.axes for k, t in tiles_of.items()
             if k.startswith("params/")}
    norm_groups = {k: mesh.group_over(axes) for k, axes in split.items()}
    layer_tiles = model_tiles(mesh, tiles_of) if tiles_of else None
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
        with shard_contexts(mesh, batch_axis, seq_axis, layer_tiles):
            (loss, aux), grads = grads_of(state["params"], batch)
        grads = reduce_step_grads(grads, mesh, shards, split)
        gnorm = None
        if grad_clip:
            norm = _global_norm(grads, norm_groups) if split \
                else global_norm(grads)
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
    step_fn.layout = tiles_of
    if not init_state:
        return step_fn, None
    flat = bridge.flatten(params)
    own = bridge.unflatten(bridge.structure(params), {
        k: (local_block(p, tiles_of["params/" + k])
            if "params/" + k in tiles_of else p).detach().clone()
        for k, p in flat.items()})
    state = {"params": own, "opt": optimizer.init(own)}
    collectives.broadcast_(_part(state, lambda k: k not in tiles_of), group)
    # each tile from the first rank that holds it
    for axes, paths in sorted(_by_axes(
            {k: t.axes for k, t in tiles_of.items()}).items()):
        replicas = replica_group(mesh, axes)
        if replicas is not None:
            collectives.broadcast_(_part(state, paths.__contains__),
                                   replicas,
                                   src=dist.get_global_rank(replicas, 0))
    return step_fn, state
