"""Pipeline parallelism: GPipe over a ``pp`` mesh axis, the port of
``paddle_operator_tpu/parallel/pipeline.py``, function by function.

A stack of stages of one shape holds its parameters stacked on a leading
stage axis (:func:`stack_stage_params`); rank i of the ``pp`` axis runs
stage i (:func:`shard_stacked_params` cuts its block). The global input
``[batch, ...]`` is the same on every rank; it is split into M
microbatches, and stage s works on microbatch t at tick s + t, so a
sweep takes M + S - 1 ticks (the bubble is (S - 1) / (M + S - 1) of it).
The activations hop from stage to stage over the pp group
(:func:`.collectives.pipeline_hop`, the reference's ``lax.ppermute``).

The pieces are autograd functions of :mod:`.collectives`, so
``torch.autograd`` runs the schedule backwards: each hop's backward is
the hop the other way; the output, replicated, is the sum over the
stages of the last stage's buffer (:func:`.collectives.sum_forward`),
whose backward is the identity, since every rank's loss is the same
replicated loss (the reference's ``psum`` of a ``P()`` output
transposes so); and the input, replicated, goes through
:func:`.collectives.sum_backward`, whose backward sums the stages'
cotangents (stage 0's alone is not zero), as the reference's ``P()``
input transposes. Every rank runs the same graph: the choices that
depend on the stage are tensors (``torch.where``, as the reference's
``jnp.where``), so every hop of every tick is on every rank's graph and
its backward runs on every rank, in the same order (tick by tick
backwards), and no rank waits on a hop another skips.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .. import bridge
from . import collectives
from .mesh import Mesh


def stack_stage_params(per_stage_params) -> Any:
    """``[tree per stage]`` -> one tree whose leaves are the stages'
    leaves stacked on a new leading stage axis."""
    return bridge.tree_map(lambda *leaves: torch.stack(leaves),
                           *per_stage_params)


def param_slot(stage: int, n_stages: int) -> int:
    """The block of the stacked tree that the rank at pp coordinate
    ``stage`` runs: its own."""
    return stage


def shard_stacked_params(stage_params: Any, mesh: Mesh,
                         axis: str = "pp") -> Any:
    """This rank's block of a stacked tree: each leaf's block of its
    leading axis at the rank's ``axis`` coordinate, the leading axis of 1
    kept (the reference places the tree with ``NamedSharding(mesh,
    P(axis))``, whose shard on a device is this block)."""
    slot = param_slot(mesh.axis_rank(axis), mesh.axis_size(axis))
    return bridge.tree_map(lambda a: a.narrow(0, slot, 1), stage_params)


def bank_index(t: int, n_stages: int) -> int:
    """The microbatch the last stage's output at tick ``t`` is (before the
    clip to ``[0, M)``): the one stage 0 injected S - 1 ticks earlier."""
    return t - (n_stages - 1)


def _stage_tree(stage_params: Any, mesh: Mesh, axis: str) -> Any:
    """This rank's stage's parameters, the leading axis dropped, from the
    whole stacked tree (leading axis S) or this rank's block (1)."""
    n = mesh.axis_size(axis)
    leads = {int(a.shape[0]) for a in bridge.leaves(stage_params)}
    if leads == {1}:
        return bridge.tree_map(lambda a: a[0], stage_params)
    if leads != {n}:
        raise ValueError(
            "stacked stage params have leading axes %s: a pipeline over %s "
            "of size %d takes the whole stacked tree (leading axis %d) or "
            "this rank's block (leading axis 1)" % (sorted(leads), axis, n,
                                                    n))
    group = mesh.axis_group(axis)
    slot = param_slot(mesh.axis_rank(axis), n)
    return bridge.tree_map(
        lambda a: collectives.stage_slice(a, group, slot)[0], stage_params)


def pipeline_apply(stage_params: Any, x: torch.Tensor, stage_fn: Callable,
                   mesh: Mesh, n_microbatches: int,
                   axis: str = "pp") -> torch.Tensor:
    """Run ``x`` through the stage pipeline, the reference's semantics:

    * ``stage_params``: either the whole stacked tree, leading axis
      ``mesh.axis_size(axis)`` on every leaf (its gradient is then whole
      on every rank: each stage's block of the cotangent is gathered over
      ``axis``), or this rank's block of it from
      :func:`shard_stacked_params`, leading axis 1 (its gradient is this
      rank's block);
    * ``x``: ``[batch, ...]``, the same on every rank; split into
      ``n_microbatches`` along the batch axis;
    * ``stage_fn(params, microbatch) -> microbatch`` of the same shape,
      ``params`` the stage's tree without the leading axis.

    M + S - 1 ticks: stage 0 takes microbatch ``clip(t, 0, M - 1)``,
    every other stage what arrived from the one before; every stage runs
    ``stage_fn`` on every tick, the junk ticks of the bubble included;
    the last stage banks its output as microbatch ``t - (S - 1)`` from
    tick S - 1 on; the output hops to stage ``(i + 1) % S`` after each
    tick but the last (whose carry no tick reads). Every rank returns the
    sum over ``axis`` of the last stage's buffer, ``[batch, ...]``.
    Every rank of the mesh must call this in the same order (it runs
    collectives over ``axis``); the dp replicas of a stage compute the
    same thing."""
    n_stages = mesh.axis_size(axis)
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError("batch %d must divide into %d microbatches"
                         % (batch, n_microbatches))
    group = mesh.axis_group(axis)
    stage = mesh.axis_rank(axis)
    my_params = _stage_tree(stage_params, mesh, axis)
    x = collectives.sum_backward(x, group, collectives.pp_traffic)
    xs = x.reshape(n_microbatches, batch // n_microbatches, *x.shape[1:])
    total = n_microbatches + n_stages - 1

    def flag(value: bool) -> torch.Tensor:
        return torch.tensor(value, device=x.device)

    first, last = flag(stage == 0), stage == n_stages - 1
    out_buf = torch.zeros_like(xs)
    carry = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=x.device)
    for t in range(total):
        # stage 0 injects microbatch t (or junk after the last one)
        inp = torch.where(first, xs[min(t, n_microbatches - 1)], carry)
        out = stage_fn(my_params, inp)
        # the last stage banks its result at t - (S - 1)
        at = min(max(bank_index(t, n_stages), 0), n_microbatches - 1)
        banked = torch.cat([out_buf[:at], out.to(out_buf.dtype)[None],
                            out_buf[at + 1:]])
        out_buf = torch.where(flag(last and t >= n_stages - 1), banked,
                              out_buf)
        if t < total - 1:
            carry = collectives.pipeline_hop(out, group)
    # only the last stage holds data: the sum hands it to every rank
    has_data = float(last)
    out = collectives.sum_forward(out_buf * has_data, group,
                                  collectives.pp_traffic)
    return out.reshape(batch, *x.shape[1:])
