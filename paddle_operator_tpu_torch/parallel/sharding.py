"""Path-pattern sharding rules over parameter trees: the port's copy of
``paddle_operator_tpu/parallel/sharding.py``'s rule tables and of
``shard_tree``'s choice.

A rule set is an ordered list of ``(regex, spec)``, ``spec`` a tuple with
one entry per leading dimension of the leaf: a mesh axis name, a tuple of
names, or ``None``. The first regex that matches a leaf's flat path
(:func:`..bridge.flatten`'s names, ``layers/3/moe/wi``) wins; axes the
mesh lacks are dropped (one rule set serves many meshes), and a leaf whose
dimensions do not divide by the axes left falls back to replicated.

There is no GSPMD here: :func:`shard_tree` only says which dimension of
each leaf is split over which axis, and :func:`tile_of` which block of
each such dimension a rank holds. The train step (:mod:`.train`) uses
them to hold a rank's tile of every leaf the rules split (over ``ep``,
``tp`` or ``fsdp``), and the models' layers compute on those tiles.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from .. import bridge

Spec = Tuple[Any, ...]
Rules = List[Tuple[str, Spec]]


def _names(axis: Any) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def spec_fits(shape: Tuple[int, ...], spec: Spec,
              mesh_shape: Dict[str, int]) -> bool:
    """Whether each dimension of ``shape`` divides by the product of the
    mesh axes ``spec`` assigns it (every named axis in the mesh)."""
    if len(spec) > len(shape):
        return False
    for dim, axis in zip(shape, spec):
        if axis is None:
            continue
        size = 1
        for name in _names(axis):
            if name not in mesh_shape:
                return False
            size *= mesh_shape[name]
        if dim % size:
            return False
    return True


def named(spec: Spec, mesh_shape: Dict[str, int]) -> Spec:
    """``spec`` with the axes the mesh lacks dropped: an entry of several
    names keeps those in the mesh (one name alone, none as ``None``)."""
    out = []
    for axis in spec:
        if axis is None:
            out.append(None)
            continue
        kept = tuple(n for n in _names(axis) if n in mesh_shape)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


def shard_tree(tree: Any, mesh_shape: Dict[str, int],
               rules: Optional[Rules] = None,
               default: Spec = ()) -> Dict[str, Spec]:
    """``{flat path: spec}`` for every leaf of ``tree`` (tensors or
    arrays: only ``.shape`` is read), the reference's ``shard_tree``
    choice: the first rule whose regex searches the leaf's path, its
    axes the mesh lacks dropped, if the leaf fits it; else ``default``."""
    out = {}
    for path, leaf in bridge.flatten(tree).items():
        spec = rule_spec(path, rules, mesh_shape)
        if spec is None or not spec_fits(tuple(getattr(leaf, "shape", ())),
                                         spec, mesh_shape):
            spec = named(default, mesh_shape)
        out[path] = spec
    return out


def rule_spec(path: str, rules: Optional[Rules],
              mesh_shape: Dict[str, int]) -> Optional[Spec]:
    """The spec of the first rule whose regex searches ``path``, the axes
    the mesh lacks dropped; ``None`` if no rule matches."""
    for rx, spec in rules or ():
        if re.search(rx, path):
            return named(spec, mesh_shape)
    return None


def split_axes(spec: Spec) -> Dict[int, Tuple[str, ...]]:
    """``{dimension: axis names}`` of the dimensions ``spec`` splits."""
    return {i: _names(a) for i, a in enumerate(spec) if a is not None}


def tile_of(spec: Spec, mesh_shape: Dict[str, int],
            coords: Dict[str, int]) -> Dict[int, Tuple[int, int]]:
    """``{dimension: (index, count)}``: the block of each dimension that
    ``spec`` splits over axes of size above 1 held by the rank at
    ``coords`` (its index along each axis). An entry of several axes
    counts row-major over them in the entry's order, as ``NamedSharding``
    lays out its devices: ``("dp", "tp")`` on ``{"dp": 2, "tp": 4}`` puts
    the rank at dp 1, tp 2 on block 6 of 8. Empty for a replicated
    leaf."""
    out = {}
    for dim, names in split_axes(spec).items():
        index, count = 0, 1
        for name in names:
            size = mesh_shape.get(name, 1)
            index = index * size + coords.get(name, 0)
            count *= size
        if count > 1:
            out[dim] = (index, count)
    return out


class LeafTile(NamedTuple):
    """A rank's tile of a leaf the rules split: ``blocks`` its
    ``{dimension: (index, count)}`` (:func:`tile_of`), ``axes`` the mesh
    axes the leaf is split over (the ranks along every other axis hold
    the same tile)."""

    blocks: Dict[int, Tuple[int, int]]
    axes: Tuple[str, ...]


def cut(leaf: Any, tile: Dict[int, Tuple[int, int]]) -> Any:
    """Block ``tile`` (:func:`tile_of`) of ``leaf`` (a tensor or an array:
    a view)."""
    index = [slice(None)] * len(leaf.shape)
    for dim, (i, n) in tile.items():
        size = leaf.shape[dim] // n
        index[dim] = slice(i * size, (i + 1) * size)
    return leaf[tuple(index)]


# ---------------------------------------------------------------------------
# model rule sets (the reference's tables, spec for spec)
# ---------------------------------------------------------------------------

def _megatron_tp_rules() -> Rules:
    """Shared transformer TP layout: column-parallel qkv/fc1, row-parallel
    o/fc2, vocab-sharded token embedding."""
    return [
        (r"attn/(q|k|v)/kernel", (None, "tp", None)),
        (r"attn/(q|k|v)/bias", ("tp", None)),
        (r"attn/o/kernel", ("tp", None, None)),
        (r"mlp/fc1/kernel", (None, "tp")),
        (r"mlp/fc1/bias", ("tp",)),
        (r"mlp/fc2/kernel", ("tp", None)),
        (r"embed/tok/table", ("tp", None)),
    ]


def bert_rules() -> Rules:
    """BERT: the Megatron TP base and a vocab-sharded MLM decoder."""
    return _megatron_tp_rules() + [
        (r"mlm/decoder/kernel", (None, "tp")),
        (r"mlm/decoder/bias", ("tp",)),
    ]


def gpt_rules() -> Rules:
    """GPT decoder: the Megatron TP base and a vocab-sharded LM head."""
    return _megatron_tp_rules() + [
        (r"lm_head/kernel", (None, "tp")),
    ]


def moe_rules() -> Rules:
    """MoE: the expert axis of ``wi``/``wo`` over ``ep``; the router is
    replicated."""
    return [
        (r"moe/w(i|o)$", ("ep", None, None)),
    ]


def resnet_rules() -> Rules:
    """ResNet: data parallel; an fsdp axis would shard the classifier."""
    return [
        (r"head/fc/kernel", (None, "fsdp")),
    ]


def ctr_rules() -> Rules:
    """CTR models: the embedding tables by row over the model axes (the
    reference's ``P(("tp",), None)``, which ``PartitionSpec`` holds as
    ``("tp", None)``)."""
    return [
        (r"(embed|wide|fm_first|fm_embed)/table", ("tp", None)),
    ]
