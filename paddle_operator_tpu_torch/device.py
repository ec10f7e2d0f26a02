"""Where the port's entry points run: CUDA unless the caller asks for the CPU.

Every public entry point that places tensors (``ServingEngine``,
``PagedKvCache``, ``bridge.params_from_numpy``, ``run_training``) takes a
``device`` argument and resolves it here. ``None`` means CUDA; asking for
CUDA without a card raises rather than carrying on on the CPU. The tests
pass ``device="cpu"`` explicitly.

:func:`deterministic_algorithms` switches PyTorch's deterministic
algorithms for the port's eager code.
"""

from __future__ import annotations

import sys
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike, what: str = "the port") -> torch.device:
    """``None`` means CUDA; CUDA without a card raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "%s runs on CUDA unless given device='cpu', and "
            "torch.cuda.is_available() is False" % what)
    return dev


def deterministic_algorithms(mode: bool) -> None:
    """``torch.use_deterministic_algorithms(mode)`` for eager code, without
    the import of ``torch._inductor.config`` it makes (which imports
    ``torch._dynamo``: seconds in every process that sets the switch).
    Inductor's own flag, which only compiled code reads, is set where
    inductor is already loaded."""
    inductor = sys.modules.get("torch._inductor.config")
    if inductor is not None:
        inductor.deterministic = bool(mode)
    torch._C._set_deterministic_algorithms(bool(mode), warn_only=False)
