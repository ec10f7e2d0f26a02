"""The device mesh of the port: ``paddle_operator_tpu/parallel/mesh.py``'s
``make_mesh`` and ``mesh_from_env``, over processes.

The port runs one process per card, so a mesh axis spans processes of
the ``torch.distributed`` world. Only ``dp`` is ported: an axis of any
other name with a size above 1 raises (ROADMAP A9 holds tp, sp, fsdp, ep
and pipeline meshes).

A :class:`Mesh` is backed by the default (world) process group, not by
``torch.distributed.device_mesh``: a dp-only mesh over one card a
process is the world group itself, and the train step, sync BatchNorm
and the checkpoint barriers need only its rank, size and collectives
(:mod:`.collectives`), on NCCL and on gloo alike. A process that never
joined a group (one worker) gets a mesh of one with no group, whose
collectives are the identity.

The runner's control collectives (the agreed drain poll, the checkpoint
barriers, the agreed restore) run on ``Mesh.control``: the group itself
on gloo, and on NCCL a gloo group over the same ranks, so that a poll at
every step boundary reads a host value without waiting for the card.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch.distributed as dist

#: the mesh axes the port has ported
PORTED_AXES = ("dp",)


@dataclass(frozen=True)
class Mesh:
    """An ordered ``{axis: size}`` mesh over the world's processes.
    ``shape`` is a plain dict (the runner records it in ``mesh_history``);
    ``group`` is the process group (``None``: one process, no group) and
    ``control`` the group of host-side control collectives."""

    shape: Dict[str, int]
    group: Optional[dist.ProcessGroup] = None
    control: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0


def world_size() -> int:
    """Processes in the ``torch.distributed`` world (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(axes: Optional[Dict[str, int]] = None,
              world: Optional[int] = None) -> Mesh:
    """Build a Mesh from an ordered ``{axis: size}`` dict over ``world``
    processes (default: the process group's size, 1 without one).

    Sizes of -1 are inferred (at most one). Default: every process on
    ``dp``. The sizes must cover the world exactly, as the reference's
    must cover its devices."""
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
                "mesh axis %r of size %d: the port shards over dp only; tp, "
                "sp, fsdp, ep and pipeline meshes wait for ROADMAP A9"
                % (name, size))
    if not dist.is_initialized():
        return Mesh(axes)
    group = dist.group.WORLD
    control = group
    if dist.get_backend(group) == "nccl" and n > 1:
        control = dist.new_group(backend="gloo")
    return Mesh(axes, group, control)


def mesh_from_env(world: Optional[int] = None) -> Mesh:
    """Mesh shape from ``TPUJOB_MESH`` (e.g. ``dp=2``), as far as dp goes;
    a multislice ``TPUJOB_DCN_MESH`` is not ported and raises."""
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
            "ROADMAP A9")
    return make_mesh(parse(os.environ.get("TPUJOB_MESH", "")) or None,
                     world)
