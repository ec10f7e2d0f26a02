"""Parameter trees between the JAX package and the port, as numpy.

The JAX package's parameter trees are nested dicts and lists of arrays
(``paddle_operator_tpu.models.gpt.init``, ``models.resnet.init``).
:func:`params_from_numpy` turns such a tree, with its leaves as numpy
arrays, into the same tree of torch tensors on a device;
:func:`params_to_numpy` goes back. The keys and the layouts are kept as
they are (the port's layers take the JAX layouts: HWIO conv kernels,
``[in, out]`` dense kernels, BatchNorm ``{scale, bias, mean, var}`` leaves
inside the tree), so a round trip is bit-equal.

:func:`flatten` names each leaf by its path, ``"stages/0/1/conv2/kernel"``,
exactly as the JAX package's checkpoint writer does (sorted dict keys,
list indices), so checkpoints cross between the two packages.
:func:`tile_slice` cuts a whole tree to what one rank of any mesh holds
under a rule set (its tile of every leaf the rules split), so that a
JAX-initialised tree starts a tensor-, fully-sharded- or
expert-parallel run of the port; :func:`ep_slice` is its case of an
``ep`` axis alone.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf over dict/list trees of the same shape.
    ``None`` leaves of the first tree stay ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def leaves(tree: Any) -> list:
    """The leaves in :func:`flatten`'s order (sorted keys, list order)."""
    return list(flatten(tree).values())


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Copy a dict/list tree of numpy arrays into torch tensors on
    ``device``. ``None`` means CUDA, and raises without a card. Leaves
    keep their dtype and shape."""
    dev = resolve_device(device, "bridge.params_from_numpy")
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """Copy a dict/list tree of torch tensors back into numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"a/0/b": leaf}``: the flat path names of the JAX package's
    ``utils/checkpoint._flatten``."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], "%s%s/" % (prefix, k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, "%s%d/" % (prefix, i)))
    else:
        out[prefix[:-1]] = tree
    return out


def structure(tree: Any) -> Any:
    """The tree with every leaf replaced by ``None`` (tuples as lists),
    as the checkpoint manifest stores it."""
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [structure(v) for v in tree]
    return None


def unflatten(struct: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    """Inverse of :func:`flatten` given :func:`structure`'s output."""
    if isinstance(struct, dict):
        return {k: unflatten(v, flat, "%s%s/" % (prefix, k))
                for k, v in struct.items()}
    if isinstance(struct, list):
        return [unflatten(v, flat, "%s%d/" % (prefix, i))
                for i, v in enumerate(struct)]
    return flat[prefix[:-1]]


def tile_slice(tree: Any, mesh_shape: Dict[str, int],
               coords: Dict[str, int], rules: Any) -> Any:
    """``tree`` (numpy or torch leaves) as the rank at ``coords`` (its
    index along each axis) of a mesh of ``mesh_shape`` holds it: each
    leaf that ``rules`` split (``parallel.sharding.shard_tree``'s choice)
    cut to that rank's tile (``parallel.sharding.tile_of``), the others
    as they are."""
    from .parallel import sharding

    specs = sharding.shard_tree(tree, mesh_shape, rules)
    return unflatten(structure(tree), {
        path: sharding.cut(leaf, sharding.tile_of(specs[path], mesh_shape,
                                                  coords))
        if sharding.tile_of(specs[path], mesh_shape, coords) else leaf
        for path, leaf in flatten(tree).items()})


def ep_slice(tree: Any, index: int, count: int, rules: Any = None) -> Any:
    """``tree`` as the rank at index ``index`` of an ``ep`` axis of
    ``count`` holds it (:func:`tile_slice` on ``{"ep": count}``): each
    leaf that ``rules`` (default: ``parallel.sharding.moe_rules()``)
    split over ep cut to block ``index`` of its leading axis, the others
    as they are."""
    from .parallel import sharding

    rules = sharding.moe_rules() if rules is None else rules
    return tile_slice(tree, {"ep": count}, {"ep": index}, rules)
