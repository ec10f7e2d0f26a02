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
identical on every rank from then on. Parameters and optimizer state are
replicated: sharding rules over an axis of the mesh, and ``seq_axis``,
raise (ROADMAP A9).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from .. import bridge
from ..data import process_shard
from ..ops.optim import Optimizer, clip_by_global_norm
from . import collectives
from .mesh import Mesh


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
    """Refuse what the dp-only port cannot shard: a sequence axis, a
    batch axis the mesh lacks, and rules that name an axis of the mesh.
    Rules whose axes are all missing from the mesh mean "replicated", as
    the reference's rule tables do there."""
    if seq_axis is not None:
        raise NotImplementedError(
            "seq_axis=%r: sequence parallelism is not ported (ROADMAP A9)"
            % seq_axis)
    if batch_axis not in mesh.shape:
        raise ValueError("batch axis %r is not an axis of the mesh %s"
                         % (batch_axis, mesh.shape))
    for pattern, spec in rules or ():
        for axis in spec:
            names = axis if isinstance(axis, tuple) else (axis,)
            named = [n for n in names if n is not None and n in mesh.shape]
            if named:
                raise NotImplementedError(
                    "sharding rule %r shards over mesh axis %r; the port "
                    "replicates parameters (ROADMAP A9)" % (pattern,
                                                           named[0]))


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
    * ``mesh``: a dp :class:`.mesh.Mesh`. ``host_local_batches=False``:
      ``step_fn`` takes the GLOBAL batch, the same on every rank, and
      each rank trains on its contiguous block of the batch axis
      (:func:`batch_axis_of`); ``True``: ``step_fn`` takes this rank's
      block as it is. ``rules`` naming only axes the mesh lacks are
      accepted (replicated); other rules and ``seq_axis`` raise.
    """
    group = None
    if mesh is not None:
        _check_mesh(mesh, rules, batch_axis, seq_axis)
        group = mesh.group
    # the per-step batch's axis that the mesh splits (the [K] axis is
    # sliced off before step() sees the batch)
    split_axis = batch_axis_of(accum_steps)
    take_block = mesh is not None and not host_local_batches \
        and mesh.size > 1

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
            batch = process_shard(batch, mesh.rank, mesh.size,
                                  axis=split_axis)
        with collectives.sync_batch(group):
            (loss, aux), grads = grads_of(state["params"], batch)
        grads = collectives.mean_grads(grads, group)
        gnorm = None
        if grad_clip:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        optimizer.update(grads, state["opt"], state["params"])
        if merge_stats is not None and isinstance(aux, dict) \
                and "stats" in aux:
            merge_stats(state["params"], aux["stats"])
            aux = {k: v for k, v in aux.items() if k != "stats"}
        metrics = {"loss": loss}
        if isinstance(aux, dict):
            metrics.update(_detach(aux))
        metrics = collectives.mean_metrics(metrics, group)
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
    if not init_state:
        return step_fn, None
    own = bridge.tree_map(lambda p: p.detach().clone(), params)
    state = {"params": own, "opt": optimizer.init(own)}
    return step_fn, collectives.broadcast_(state, group)
