"""The device mesh of the port: ``paddle_operator_tpu/parallel/mesh.py``'s
``make_mesh`` and ``mesh_from_env``, over processes.

The port runs one process per card, so a mesh axis spans processes of
the ``torch.distributed`` world. ``dp``, ``sp``, ``ep``, ``tp``,
``fsdp`` and the pipeline's ``pp`` are ported: an axis of any other name
with a size above 1 raises, as does a multislice ``TPUJOB_DCN_MESH``
(ROADMAP A5.3).

Ranks are laid out as the reference lays out devices: row-major over the
axes in dict order, so with ``{"dp": 2, "sp": 2}`` (dp outermost, sp
innermost) rank = dp_index * 2 + sp_index. A :class:`Mesh` holds the
world group (``group``: the gradient and metric reductions, sync
BatchNorm, the checkpoint) and, for every axis, the process group of the
ranks that differ from this one only along it (:meth:`Mesh.axis_group`):
the ring and the all-to-alls of sequence parallelism run on the sp
group, the pipeline's hops on the pp group (:mod:`.pipeline`), the
batch split takes the dp coordinate, the ep group sums a MoE
layer's local experts, the tp group sums a row-parallel layer's partial
products and the fsdp group gathers ResNet's classifier. :meth:`Mesh.group_over` gives the group of the
ranks that differ from this one only along several axes: the ranks that
hold distinct tokens (every axis but the model axes ep, tp and fsdp) or
that hold the same tile of a split leaf (every axis but the leaf's own). An axis set that spans the whole world uses the world
group itself, one of size 1 none. A process that never joined a group
(one worker) gets a mesh with no group, whose collectives are the
identity.

The runner's control collectives (the agreed drain poll, the checkpoint
barriers, the agreed restore) run on ``Mesh.control``: the group itself
on gloo, and on NCCL a gloo group over the same ranks, so that a poll at
every step boundary reads a host value without waiting for the card.
"""

from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch.distributed as dist

#: the mesh axes the port has ported
PORTED_AXES = ("dp", "sp", "ep", "tp", "fsdp", "pp")


@dataclass(frozen=True)
class Mesh:
    """An ordered ``{axis: size}`` mesh over the world's processes.
    ``shape`` is a plain dict (the runner records it in ``mesh_history``);
    ``group`` is the world's process group (``None``: one process, no
    group), ``control`` the group of host-side control collectives and
    ``groups`` this rank's group along each axis (``None`` for an axis of
    size 1, or without a process group)."""

    shape: Dict[str, int]
    group: Optional[dist.ProcessGroup] = None
    control: Optional[dist.ProcessGroup] = None
    groups: Dict[str, Optional[dist.ProcessGroup]] = field(
        default_factory=dict)
    # the groups along several axes, by the frozenset of their names
    # (axes of size 1 left out)
    multi: Dict[frozenset, Optional[dist.ProcessGroup]] = field(
        default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis (row-major, dict order)."""
        out, rest = {}, self.rank
        for name, size in reversed(list(self.shape.items())):
            out[name], rest = rest % size, rest // size
        return {name: out[name] for name in self.shape}

    def axis_size(self, name: str) -> int:
        """The size of axis ``name`` (1 for an axis the mesh lacks)."""
        return self.shape.get(name, 1)

    def axis_rank(self, name: str) -> int:
        """This rank's index along axis ``name`` (0 if the mesh lacks
        it)."""
        return self.coords().get(name, 0)

    def axis_group(self, name: str) -> Optional[dist.ProcessGroup]:
        """The process group of the ranks that differ from this one only
        along ``name`` (``None`` for an axis of size 1)."""
        return self.groups.get(name)

    def group_over(self, names) -> Optional[dist.ProcessGroup]:
        """The process group of the ranks that share every coordinate
        with this one except those along ``names`` (axes the mesh lacks,
        or of size 1, change nothing): ``None`` when that is this rank
        alone, the world group when it is every rank."""
        live = frozenset(n for n in names if self.axis_size(n) > 1)
        if not live:
            return None
        if len(live) == 1:
            return self.groups.get(next(iter(live)))
        if math.prod(self.shape[n] for n in live) == self.size:
            return self.group
        return self.multi.get(live)


def world_size() -> int:
    """Processes in the ``torch.distributed`` world (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _group_along(axes: Dict[str, int], along: Tuple[int, ...], rank: int
                 ) -> dist.ProcessGroup:
    """This rank's group of the ranks that differ from it only along the
    axes at indices ``along``. ``new_group`` is collective over the
    world: every rank creates every such subgroup, in one order (by the
    other axes' coordinates), and keeps the one it belongs to."""
    sizes = list(axes.values())
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    others = [range(s) if j not in along else range(1)
              for j, s in enumerate(sizes)]
    inner = [range(sizes[j]) for j in along]
    mine = None
    for base in itertools.product(*others):
        start = sum(c * st for c, st in zip(base, strides))
        ranks = [start + sum(c * strides[j] for c, j in zip(cs, along))
                 for cs in itertools.product(*inner)]
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def _axis_groups(axes: Dict[str, int], rank: int, world_group
                 ) -> Tuple[Dict[str, Optional[dist.ProcessGroup]],
                            Dict[frozenset, Optional[dist.ProcessGroup]]]:
    """This rank's group along each axis, then along each set of two or
    more axes of size above 1 that is not the whole world (axis by axis,
    then set by set in a fixed order, the same on every rank)."""
    names, sizes = list(axes), list(axes.values())
    out: Dict[str, Optional[dist.ProcessGroup]] = {}
    for i, name in enumerate(names):
        if sizes[i] == 1:
            out[name] = None
        elif sizes[i] == math.prod(sizes):
            out[name] = world_group
        else:
            out[name] = _group_along(axes, (i,), rank)
    live = [i for i, s in enumerate(sizes) if s > 1]
    multi: Dict[frozenset, Optional[dist.ProcessGroup]] = {}
    for k in range(2, len(live)):
        for along in itertools.combinations(live, k):
            multi[frozenset(names[i] for i in along)] = _group_along(
                axes, along, rank)
    return out, multi


def make_mesh(axes: Optional[Dict[str, int]] = None,
              world: Optional[int] = None) -> Mesh:
    """Build a Mesh from an ordered ``{axis: size}`` dict over ``world``
    processes (default: the process group's size, 1 without one).

    Sizes of -1 are inferred (at most one). Default: every process on
    ``dp``. The sizes must cover the world exactly, as the reference's
    must cover its devices. In a process group every rank must call this
    with the same axes: it creates the axes' subgroups."""
    n = world_size() if world is None else world
    if not axes:
        axes = {"dp": n}
    axes = dict(axes)
    known = math.prod(s for s in axes.values() if s != -1)
    unknown = [a for a, s in axes.items() if s == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis size may be -1")
    if unknown:
        if n % known:
            raise ValueError("cannot infer %s: %d %% %d != 0"
                             % (unknown[0], n, known))
        axes[unknown[0]] = n // known
    total = math.prod(axes.values())
    if total != n:
        raise ValueError(
            "mesh %s covers %d devices but %d are available" % (axes, total,
                                                                n))
    for name, size in axes.items():
        if name not in PORTED_AXES and size > 1:
            raise NotImplementedError(
                "mesh axis %r of size %d: the port shards over %s only"
                % (name, size, ", ".join(PORTED_AXES)))
    if not dist.is_initialized():
        return Mesh(axes)
    group = dist.group.WORLD
    control = group
    if dist.get_backend(group) == "nccl" and n > 1:
        control = dist.new_group(backend="gloo")
    groups, multi = _axis_groups(axes, dist.get_rank(group), group)
    return Mesh(axes, group, control, groups, multi)


def mesh_from_env(world: Optional[int] = None) -> Mesh:
    """Mesh shape from ``TPUJOB_MESH`` (e.g. ``dp=2,sp=2`` or
    ``pp=4,dp=2``), over the
    ported axes; a multislice ``TPUJOB_DCN_MESH`` is not ported and
    raises."""
    def parse(s: str) -> Dict[str, int]:
        axes: Dict[str, int] = {}
        for part in s.split(","):
            if part.strip():
                name, _, size = part.partition("=")
                axes[name.strip()] = int(size)
        return axes

    if parse(os.environ.get("TPUJOB_DCN_MESH", "")):
        raise NotImplementedError(
            "TPUJOB_DCN_MESH (multislice hybrid meshes) is not ported; "
            "ROADMAP A5.3")
    return make_mesh(parse(os.environ.get("TPUJOB_MESH", "")) or None,
                     world)
