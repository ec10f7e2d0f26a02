"""The train step: the single-device port of
``paddle_operator_tpu/parallel/train.py``'s ``build_train_step``.

``step_fn(state, batch) -> (state, metrics)`` computes the loss and its
grads with autograd, optionally clips them, applies the optimizer and then
folds BatchNorm running stats into the params (``merge_stats``, AFTER the
update, as the reference does). The state is updated in place, the
counterpart of the JAX step's ``donate_argnums=0``: ``state`` holds one
copy of params and optimizer state for the run.

Device meshes and DTensor sharding are not ported yet: ``mesh`` must be
None.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from .. import bridge
from ..ops.optim import Optimizer, clip_by_global_norm


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


def build_train_step(loss_fn: Callable, optimizer: Optimizer, params: Any,
                     sample_batch: Any, mesh: Any = None,
                     merge_stats: Optional[Callable] = None,
                     grad_clip: Optional[float] = None,
                     accum_steps: int = 1, steps_per_call: int = 1,
                     init_state: bool = True):
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
    """
    if mesh is not None:
        raise NotImplementedError(
            "build_train_step: device meshes are not ported yet; the port's "
            "train step is single-device (mesh=None)")

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
        (loss, aux), grads = grads_of(state["params"], batch)
        metrics = {"loss": loss}
        if grad_clip:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            metrics["grad_norm"] = gnorm
        optimizer.update(grads, state["opt"], state["params"])
        if merge_stats is not None and isinstance(aux, dict) \
                and "stats" in aux:
            merge_stats(state["params"], aux["stats"])
            aux = {k: v for k, v in aux.items() if k != "stats"}
        if isinstance(aux, dict):
            metrics.update(_detach(aux))
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
    return step_fn, {"params": own, "opt": optimizer.init(own)}
