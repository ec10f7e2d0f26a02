"""Optimizers as (init, update) pairs over parameter trees: the port of
``paddle_operator_tpu/ops/optim.py``'s SGD family and AdamW.

State is a tree with the reference's keys, ``{"step": int32 0-d,
"momentum": tree}`` (SGD) or ``{"step", "mu", "nu"}`` (AdamW), so
checkpoints cross between the two packages, and
``update(grads, state, params) -> (params, state)`` keeps the reference's
signature. Unlike the reference, the port updates ``params`` and the
momentum IN PLACE under ``torch.no_grad()`` (the counterpart of the JAX
step's ``donate_argnums=0``) and returns the same tensors.

Each update is written out operation by operation, as the reference does:
the lr is evaluated at ``step + 1``, weight decay is coupled
(``g + wd * p``), and every product and sum is its own rounding. A grad
of ``None`` (a leaf autograd never reached, such as BatchNorm's running
``mean``/``var``) counts as zeros, as the reference's ``value_and_grad``
gives zeros there; with weight decay and no mask those leaves still get
decayed momentum, exactly as in the reference.

:func:`fused_sgd` is the drop-in for :func:`sgd` that launches the
hand-written multi-tensor CUDA kernel ``csrc/fused_sgd.cu`` once per step
over every leaf (:func:`multi_tensor_sgd`). The lr is a 0-d fp32 device
tensor computed on the device, never a host float. The update does no
matrix product: ``FlopCounterMode`` counts 0 FLOPs for it on the kernel
and on the plain version alike, and the kernel reports none to the
hardware plane (:mod:`..obs.hardware`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import bridge
from . import _kernels


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (params, state)


def make_wd_mask(params: Any,
                 exclude: Sequence[str] = ("bias", "scale", "mean", "var")
                 ) -> Any:
    """Weight-decay mask: False for leaves whose path names a
    normalization, bias or BN-stat key."""
    excluded = set(exclude)

    def mask(tree: Any, names: frozenset) -> Any:
        if isinstance(tree, dict):
            return {k: mask(v, names | {k}) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(mask(v, names) for v in tree)
        return not (names & excluded)

    return mask(params, frozenset())


def _lr_tensor(lr_fn: Callable, step: torch.Tensor) -> torch.Tensor:
    """The lr at ``step`` as a 0-d fp32 tensor on the step's device."""
    lr = lr_fn(step)
    if isinstance(lr, torch.Tensor):
        return lr.to(torch.float32)
    return torch.full((), float(lr), dtype=torch.float32, device=step.device)


def _sgd_leaf_(p: torch.Tensor, g: Optional[torch.Tensor], m: torch.Tensor,
               lr: torch.Tensor, momentum: float, decay: float,
               nesterov: bool) -> None:
    """One leaf of the update, in place, in the reference's operation
    order: g' = g + decay*p; m = momentum*m + g'; d = nesterov ?
    g' + momentum*m : m; p = p - lr*d."""
    g = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
    if decay:
        g = g + decay * p
    m.mul_(momentum).add_(g)
    d = g + momentum * m if nesterov else m
    p.sub_(lr * d)


def _plain_multi_tensor_sgd(params: List[torch.Tensor],
                            grads: List[Optional[torch.Tensor]],
                            moms: List[torch.Tensor], decays: List[float],
                            lr: torch.Tensor, momentum: float,
                            nesterov: bool) -> None:
    """The plain PyTorch version of ``csrc/fused_sgd.cu``: the same
    update, leaf by leaf, in torch ops (about six launches per leaf)."""
    for p, g, m, decay in zip(params, grads, moms, decays):
        _sgd_leaf_(p, g, m, lr, momentum, decay, nesterov)


# one block of the kernel updates a chunk of _CHUNK elements of one leaf
# (kChunk in csrc/fused_sgd.cu)
_CHUNK = 4096
_TABLE_COLS = 6   # p, g, m, n, decay bits, first chunk (int64 each)


def _descriptor_table(params, grads, moms, decays) -> "tuple[np.ndarray, int]":
    """The kernel's per-leaf descriptors, one int64 row each: the three
    pointers (0 for a None grad, read as zeros), the element count, the
    decay's fp32 bits and the leaf's first chunk index. Returns
    (table, number of chunks)."""
    table = np.zeros((len(params), _TABLE_COLS), dtype=np.int64)
    chunk = 0
    for i, (p, g, m, decay) in enumerate(zip(params, grads, moms, decays)):
        n = p.numel()
        table[i] = (p.data_ptr(), 0 if g is None else g.data_ptr(),
                    m.data_ptr(), n,
                    int(np.float32(decay).view(np.int32)), chunk)
        chunk += -(-n // _CHUNK)
    return table, chunk


def _check_leaves(params, grads, moms) -> None:
    dev = params[0].device
    for p, g, m in zip(params, grads, moms):
        for name, t in (("param", p), ("momentum", m), ("grad", g)):
            if t is None and name == "grad":
                continue
            if t.dtype != torch.float32:
                raise TypeError("fused SGD kernel takes fp32 leaves, got a "
                                "%s %s" % (t.dtype, name))
            if t.device != dev:
                raise ValueError("fused SGD leaves lie on different devices:"
                                 " %s and %s" % (t.device, dev))
            if not t.is_contiguous():
                raise ValueError("fused SGD kernel takes contiguous leaves")
        if g is not None and g.shape != p.shape or m.shape != p.shape:
            raise ValueError("fused SGD leaf shapes differ: %s %s %s"
                             % (tuple(p.shape), None if g is None
                                else tuple(g.shape), tuple(m.shape)))


def _launch(params, grads, moms, decays, lr, momentum, nesterov) -> None:
    _check_leaves(params, grads, moms)
    dev = params[0].device
    if lr.device != dev or lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError("fused SGD lr must be a 0-d fp32 tensor on %s" % dev)
    table, chunks = _descriptor_table(params, grads, moms, decays)
    # pinned staging, then an async copy on the current stream; the
    # caching host allocator holds the pinned block until the copy is done
    table_dev = torch.from_numpy(table).pin_memory().to(dev,
                                                        non_blocking=True)
    lib = _kernels.load("fused_sgd")
    fn = lib.fused_sgd_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table_dev.data_ptr(), len(params), chunks,
                 lr.contiguous().data_ptr(), float(momentum), int(nesterov),
                 stream)
    if err != 0:
        raise RuntimeError("fused_sgd kernel launch failed: CUDA error %d"
                           % err)
    multi_tensor_sgd.launches += 1


def multi_tensor_sgd(params: List[torch.Tensor],
                     grads: List[Optional[torch.Tensor]],
                     moms: List[torch.Tensor], decays: List[float],
                     lr: torch.Tensor, momentum: float,
                     nesterov: bool = False) -> None:
    """Update every leaf in place: for each element,
    ``g' = g + decay*p; m = momentum*m + g'; d = nesterov ? g' +
    momentum*m : m; p = p - lr*d``, with ``decay`` per leaf (0 skips it)
    and a ``None`` grad read as zeros.

    CUDA tensors: ONE launch of ``csrc/fused_sgd.cu`` over all leaves
    (fp32, contiguous), adding one to ``multi_tensor_sgd.launches``. CPU
    tensors: :func:`_plain_multi_tensor_sgd`. ``lr`` is a 0-d fp32
    tensor on the leaves' device, read by the kernel on the device."""
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        _plain_multi_tensor_sgd(params, grads, moms, decays, lr, momentum,
                                nesterov)
        return
    if dev.type != "cuda":
        raise ValueError("multi_tensor_sgd runs on cuda or cpu tensors, got "
                         "%s" % dev)
    _launch(params, grads, moms, decays, lr, momentum, nesterov)


#: kernel launches since the last reset (chip_smoke.py reads it)
multi_tensor_sgd.launches = 0


def _init_state(params: Any) -> dict:
    """Zero momentum in fp32 for every leaf (the reference starts a bf16
    leaf's momentum in bf16, but its first update makes it fp32 with the
    same value, so from step 1 on the states are equal)."""
    first = bridge.leaves(params)[0]
    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "momentum": bridge.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)}


def _decays(params: Any, weight_decay: float, wd_mask: Any) -> List[float]:
    if not weight_decay:
        return [0.0] * len(bridge.leaves(params))
    if wd_mask is None:
        return [weight_decay] * len(bridge.leaves(params))
    return [weight_decay if on else 0.0 for on in bridge.leaves(wd_mask)]


def _flat_grads(grads: Any, params: Any) -> List[Optional[torch.Tensor]]:
    """Grads in the params' leaf order; missing or None entries are None."""
    names = bridge.flatten(params)
    got = bridge.flatten(grads) if grads is not None else {}
    return [got.get(k) for k in names]


def sgd(lr: Any, momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False, wd_mask: Any = None) -> Optimizer:
    """SGD with momentum and coupled weight decay, leaf by leaf in torch
    ops (the reference's ``sgd``). ``lr`` is a float or ``step -> lr``."""
    lr_fn = lr if callable(lr) else (lambda step: lr)

    @torch.no_grad()
    def update(grads: Any, state: dict, params: Any):
        state["step"] += 1
        lr_t = _lr_tensor(lr_fn, state["step"])
        ps = bridge.leaves(params)
        for p, g, m, decay in zip(ps, _flat_grads(grads, params),
                                  bridge.leaves(state["momentum"]),
                                  _decays(params, weight_decay, wd_mask)):
            _sgd_leaf_(p, g, m, lr_t, momentum, decay, nesterov)
        return params, state

    return Optimizer(_init_state, update)


def fused_sgd(lr: Any, momentum: float = 0.9, weight_decay: float = 0.0,
              nesterov: bool = False, wd_mask: Any = None) -> Optimizer:
    """:func:`sgd` with the whole update (decay, momentum, parameter
    write) in one :func:`multi_tensor_sgd` call: one kernel launch per
    step on the card. Same state layout as :func:`sgd` (checkpoints are
    interchangeable).

    The reference's dtype rule holds: a tree whose params are not all
    fp32, or whose grads or momenta mix dtypes, takes :func:`sgd` (for
    low-precision params the reference rounds ``wd * p`` to the param
    dtype where the kernel stays in fp32: a different result, not a
    rounding difference)."""
    reference = sgd(lr, momentum=momentum, weight_decay=weight_decay,
                    nesterov=nesterov, wd_mask=wd_mask)
    lr_fn = lr if callable(lr) else (lambda step: lr)

    @torch.no_grad()
    def update(grads: Any, state: dict, params: Any):
        ps = bridge.leaves(params)
        gs = _flat_grads(grads, params)
        ms = bridge.leaves(state["momentum"])
        if ({p.dtype for p in ps} != {torch.float32}
                or len({g.dtype for g in gs if g is not None}) > 1
                or len({m.dtype for m in ms}) != 1):
            return reference.update(grads, state, params)
        state["step"] += 1
        lr_t = _lr_tensor(lr_fn, state["step"])
        multi_tensor_sgd(ps, gs, ms, _decays(params, weight_decay, wd_mask),
                         lr_t, momentum, nesterov)
        return params, state

    return Optimizer(_init_state, update)


def _adamw_state(params: Any) -> dict:
    first = bridge.leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "mu": bridge.tree_map(zeros, params),
            "nu": bridge.tree_map(zeros, params)}


def adamw(lr: Any, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, wd_mask: Any = None) -> Optimizer:
    """AdamW with decoupled weight decay (the reference's ``adamw``), in
    place. ``lr`` is a float or ``step -> lr``; the lr and the bias
    corrections ``1 - b**step`` are 0-d fp32 tensors on the device.

    Each operation of the reference runs over all leaves at once with
    ``torch._foreach_*`` (a handful of launches per operation, not one
    per leaf), in the reference's order: ``mu = b1*mu + (1-b1)*g``;
    ``nu = b2*nu + ((1-b2)*g)*g``; ``d = (mu/c1) / (sqrt(nu/c2) + eps)``;
    ``d = d + wd*p`` where the mask is on; ``p = p - lr*d``. The JAX
    package has no fused AdamW kernel, so none is written here."""
    lr_fn = lr if callable(lr) else (lambda step: lr)

    @torch.no_grad()
    def update(grads: Any, state: dict, params: Any):
        state["step"] += 1
        step = state["step"].to(torch.float32)
        lr_t = _lr_tensor(lr_fn, state["step"])
        c1 = 1.0 - torch.pow(b1, step)
        c2 = 1.0 - torch.pow(b2, step)
        ps = bridge.leaves(params)
        gs = [torch.zeros_like(p, dtype=torch.float32) if g is None
              else g.float() for p, g in zip(ps, _flat_grads(grads, params))]
        mus, nus = bridge.leaves(state["mu"]), bridge.leaves(state["nu"])
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - b1))
        g2 = torch._foreach_mul(gs, 1 - b2)
        torch._foreach_mul_(g2, gs)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, g2)
        del g2, gs
        den = torch._foreach_div(nus, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        d = torch._foreach_div(mus, c1)
        torch._foreach_div_(d, den)
        del den
        if weight_decay:
            on = [i for i, decay in enumerate(
                _decays(params, weight_decay, wd_mask)) if decay]
            if on:
                torch._foreach_add_(
                    [d[i] for i in on],
                    torch._foreach_mul([ps[i] for i in on], weight_decay))
        torch._foreach_mul_(d, lr_t)
        torch._foreach_sub_(ps, d)
        return params, state

    return Optimizer(_adamw_state, update)


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0) -> Callable:
    """Linear warmup then cosine decay, in fp32 ops on the step tensor's
    device (no host sync)."""
    def lr(step: Any) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = (torch.clamp(step / max(1, warmup_steps), max=1.0)
                if warmup_steps else 1.0)
        progress = torch.clamp((step - warmup_steps)
                               / max(1, total_steps - warmup_steps), 0.0, 1.0)
        return base_lr * warm * 0.5 * (1.0 + torch.cos(math.pi * progress))
    return lr


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (None leaves
    count as zeros)."""
    sq = [torch.sum(torch.square(t.float()))
          for t in bridge.leaves(tree) if t is not None]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(tree: Any, max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-6))``; returns
    (clipped tree, norm). ``norm`` defaults to :func:`global_norm` of the
    tree (a tree holding a shard of the gradients passes the whole's)."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return bridge.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                           tree), norm
