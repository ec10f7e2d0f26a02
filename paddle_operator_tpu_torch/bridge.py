"""Parameter trees between the JAX package and the port, as numpy.

The JAX package's parameter trees are nested dicts and lists of arrays
(``paddle_operator_tpu.models.gpt.init``). :func:`params_from_numpy`
turns such a tree, with its leaves as numpy arrays, into the same tree of
torch tensors on a device; :func:`params_to_numpy` goes back. The keys
and the layouts are kept as they are (the port's layers take the JAX
layouts), so a round trip is bit-equal.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch


def params_from_numpy(tree: Any,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Any:
    """Copy a dict/list tree of numpy arrays into torch tensors on
    ``device`` (default CPU). Leaves keep their dtype and shape."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)


def params_to_numpy(tree: Any) -> Any:
    """Copy a dict/list tree of torch tensors back into numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy().copy()
