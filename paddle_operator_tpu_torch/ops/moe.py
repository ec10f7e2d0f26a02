"""Switch-style mixture-of-experts FFN: the counterpart of
``paddle_operator_tpu/ops/moe.py``.

Top-1 routing with capacity, in the reference's two interchangeable
formulations:

* **dense** (:func:`moe_apply`, the default): one-hot dispatch and combine
  tensors ``[T, E, C]`` contracted by einsum, exactly as the reference
  writes them (including its rounding of ``gate x dispatch`` to the
  compute type);
* **fused** (:func:`moe_apply_fused`): the same routing and expert MLP,
  with dispatch and combine as two ``torch.autograd.Function``s, the
  counterparts of the reference's ``jax.custom_vjp``s. For CUDA tensors
  they launch kernels B4a (``moe_dispatch``) and B4b (``moe_combine``) of
  the hand-written ``csrc/moe.cu``; CPU tensors take the plain versions
  beside them (:func:`_plain_dispatch`, :func:`_plain_combine`). On a CUDA
  tensor the wrappers launch the kernel or raise. Dispatch's backward is
  the combine kernel with no gate; combine's backward is the dispatch
  kernel over the cotangent with the gate as its per-token scale plus,
  for the gate, a rowwise dot with the ungated combine.

``moe_apply(fused=None)`` reads ``TPUJOB_MOE_FUSED=1`` at call time and
takes the fused path only where :func:`fused_supports` holds.

Dispatch and combine move rows and scale them by a gate: no matrix
product. ``FlopCounterMode`` counts 0 FLOPs for B4 on the kernels and on
the plain versions alike, so they report none to the hardware plane
(:mod:`..obs.hardware`); the experts' MLPs around them are PyTorch
products the counter sees.

The reference pads the capacity axis to a multiple of 128 and the tokens
to its tile, and replicates the routing metadata over 128 lanes: layout
rules of the TPU. The port's expert buffers are ``[E, capacity, D]``:
the padded rows are zeros there, give ``gelu(0) = 0`` through the experts
and are never read, so the function is the same.

Across worker processes (:class:`..parallel.collectives.Split`, set by the
train step) the layer computes what the reference's GSPMD program
computes on the global batch. Routing (:func:`_route`) takes the capacity
from the global token count and each token's position in its expert's
queue over the global row-major token order: the per-row counts of every
rank are summed over the token group in one integer all-reduce, and a
token's position is its rank's offset (the rows before its row, and the
sequence blocks before its block in that row) plus its count within its
block. The aux loss is ``E * sum_e fraction_e * share_e`` with the global
fraction (no gradient) and this rank's share of the mean probability, so
that the mean over dp of the sum over sp of the ranks' terms is the
global aux loss, in value and gradient. Under ``moe_rules`` on an ``ep``
axis a rank holds the experts ``[k E/n, (k+1) E/n)`` of ``wi``/``wo``
and runs dispatch, its experts and combine on them alone (tokens routed
elsewhere fall outside the local slots); the ep ranks hold the same
tokens, so the layer's output is the sum of their combines
(:func:`..parallel.collectives.sum_forward`), and the dispatched tokens
and the gate, whose cotangents each rank computes only for its experts'
tokens, are summed over ep in the backward
(:func:`..parallel.collectives.sum_backward`). The router and the aux
loss stay outside both, replicated, so their gradients count once.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel import collectives
from ..parallel.collectives import Split
from . import _kernels, nn

F32, BF16 = torch.float32, torch.bfloat16


def moe_init(generator: torch.Generator, dim: int, mlp_dim: int,
             num_experts: int) -> Dict:
    """Router ``[dim, E]`` (xavier uniform), expert weights ``wi [E, dim,
    mlp]`` and ``wo [E, mlp, dim]`` (normal, He scale), fp32, drawn from
    ``generator`` on its device."""
    return {
        "router": {"kernel": nn.xavier_uniform(generator, (dim, num_experts))},
        "wi": nn.normal_init(generator, (num_experts, dim, mlp_dim),
                             stddev=(2.0 / dim) ** 0.5),
        "wo": nn.normal_init(generator, (num_experts, mlp_dim, dim),
                             stddev=(2.0 / mlp_dim) ** 0.5),
    }


def _route(params: Dict, x: torch.Tensor, capacity_factor: float,
           split: Optional[Split] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int, Dict]:
    """Shared top-1 routing of this rank's tokens ``x [B, S, D]`` over
    the global batch ``split`` describes (default: this rank alone):
    ``(gate [T] fp32, choice [T] int64, pos_in_expert [T] int64,
    capacity, {"moe_aux_loss"})``, ``T = B S``, choice over every expert
    of the router.

    The router runs in fp32 (a caller on the card keeps TF32 off, as
    ``chip_smoke.py`` does: a TF32 router would move near-tied tokens to
    other experts). The gate is differentiable (``max`` passes its
    cotangent to the winning probability); choice and position are
    integers. Capacity is ``max(1, int(cf T_global / E))``; a token's
    position is the count of tokens before it in the global row-major
    order that chose its expert (the reference's ``cumsum(one_hot) *
    one_hot - 1``), exact in int64 and deterministic, so a recompute
    under remat routes every token as the forward did. Every rank of the
    token group issues the one all-reduce of the counts."""
    split = split or Split()
    b, s, _ = x.shape
    e = params["router"]["kernel"].shape[1]
    blocks, seqs = split.batch_blocks, collectives.size(split.seq)
    tokens = b * s * blocks * seqs
    capacity = max(1, int(capacity_factor * tokens / e))

    logits = torch.einsum("bsd,de->bse", x.float(),
                          params["router"]["kernel"].float())
    probs = torch.softmax(logits, dim=-1)                     # [B, S, E]
    gate, choice = probs.max(dim=-1)
    onehot = F.one_hot(choice, e)                             # int64

    # every rank's count of each expert's tokens, by global row and
    # sequence block: [rows, blocks, E]
    table = torch.zeros((blocks * b, seqs, e), dtype=torch.int64,
                        device=x.device)
    rows = slice(split.batch_index * b, (split.batch_index + 1) * b)
    table[rows, split.seq_index] = onehot.sum(dim=1)
    table = collectives.sum_counts(table, split.batch)

    # load-balancing loss (Switch Transformer): E * sum_e fraction_e *
    # prob_e, the global fraction times this rank's share of the mean
    fraction = table.sum(dim=(0, 1)).float() / tokens
    mean_prob = probs.mean(dim=(0, 1)) / seqs
    aux_loss = e * torch.sum(fraction * mean_prob)

    # capacity: position of each token within its expert's queue. The
    # tokens before this rank's block of a row: the rows before it, and
    # the blocks before this one in the row
    row_counts = table.sum(dim=1)                             # [rows, E]
    before = (torch.cumsum(row_counts, dim=0) - row_counts)[rows] \
        + (torch.cumsum(table[rows], dim=1) - table[rows])[:, split.seq_index]
    # the count runs along the tokens of a [B, E, S] copy: a scan over
    # the outer dim of [S, E] (E columns) runs nearly serially on the card
    counts = torch.cumsum(onehot.transpose(1, 2).contiguous(),
                          dim=2).transpose(1, 2)              # [B, S, E]
    position = (counts + before[:, None, :]) * onehot - 1
    pos_in_expert = position.max(dim=-1).values.reshape(b * s)
    return (gate.reshape(b * s), choice.reshape(b * s), pos_in_expert,
            capacity, {"moe_aux_loss": aux_loss})


def _local_experts(params: Dict, split: Split
                   ) -> Tuple[int, int, collectives.Group]:
    """``(first, count, group)``: the experts this rank holds (the
    leading axis of ``wi``/``wo``) and the ep group that holds the rest,
    ``None`` when it holds them all."""
    e = params["router"]["kernel"].shape[1]
    n = params["wi"].shape[0]
    if n == e:
        return 0, e, None
    group = split.expert
    if collectives.size(group) * n != e:
        raise ValueError(
            "this rank holds %d of the router's %d experts, but the expert "
            "group has %d ranks" % (n, e, collectives.size(group)))
    return dist.get_rank(group) * n, n, group


def _experts(params: Dict, expert_in: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The expert MLP on ``[E, C, D]``: gelu(x wi) wo, in ``dtype``."""
    h = torch.einsum("ecd,edh->ech", expert_in, params["wi"].to(dtype))
    h = nn.gelu(h)
    return torch.einsum("ech,ehd->ecd", h, params["wo"].to(dtype))


def moe_apply(params: Dict, x: torch.Tensor, capacity_factor: float = 1.25,
              dtype: torch.dtype = BF16, fused: Optional[bool] = None,
              split: Optional[Split] = None) -> Tuple[torch.Tensor, Dict]:
    """x ``[B, S, D]`` -> (``[B, S, D]`` in ``dtype``, {"moe_aux_loss"}).

    Top-1 routing; tokens over capacity are dropped (their output row is
    zero; residual connections carry them). ``fused`` selects
    :func:`moe_apply_fused`; ``None`` reads ``TPUJOB_MOE_FUSED=1`` and
    requires :func:`fused_supports`: the dense einsum formulation stays
    the default. ``split`` says how tokens and experts lie over the
    ranks (default: :func:`..parallel.collectives.moe_split`, read
    now)."""
    e = params["router"]["kernel"].shape[1]
    if split is None:
        split = collectives.moe_split()
    if fused is None:
        fused = (os.environ.get("TPUJOB_MOE_FUSED", "0") == "1"
                 and fused_supports(x.shape, e, x.device))
    if fused:
        return moe_apply_fused(params, x, capacity_factor=capacity_factor,
                               dtype=dtype, split=split)
    b, s, d = x.shape
    tokens = b * s
    gate, choice, pos, capacity, aux = _route(params, x, capacity_factor,
                                              split)
    first, n, group = _local_experts(params, split)
    local = choice - first
    keep = _kept(local, pos, n, capacity)

    # dense dispatch tensor [T, E_local, C]
    dispatch = (F.one_hot(torch.clamp(local, 0, n - 1), n).float()[:, :, None]
                * F.one_hot(torch.clamp(pos, 0, capacity - 1),
                            capacity).float()[:, None, :]
                * keep[:, None, None])
    xf = collectives.sum_backward(x.reshape(tokens, d).to(dtype), group)
    gate = collectives.sum_backward(gate, group)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dtype), xf)
    expert_out = _experts(params, expert_in, dtype)
    combine = dispatch * gate[:, None, None]
    out = torch.einsum("tec,ecd->td", combine.to(dtype), expert_out)
    out = collectives.sum_forward(out, group)
    return out.reshape(b, s, d), aux


def fused_supports(x_shape: Sequence[int], num_experts: int,
                   device: torch.device) -> bool:
    """Whether ``moe_apply(fused=None)`` may take the kernels: ``[B, S,
    D]`` activations on a CUDA device, at least one expert. The kernels
    take any B, S, D; the reference's 128-lane and 8-row conditions are
    TPU tiling rules. CPU tensors are refused, as the reference refuses
    any backend but the TPU: the env-gated path runs the kernels or the
    dense formulation, never the plain versions (tests call
    :func:`moe_apply_fused` directly)."""
    if len(x_shape) != 3 or num_experts < 1:
        return False
    return torch.device(device).type == "cuda"


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------

def _kept(choice: torch.Tensor, pos: torch.Tensor, n_experts: int,
          capacity: int) -> torch.Tensor:
    """Tokens that own a slot: a valid expert and a position < capacity."""
    return ((choice >= 0) & (choice < n_experts) & (pos >= 0)
            & (pos < capacity))


def _plain_dispatch(x: torch.Tensor, choice: torch.Tensor, pos: torch.Tensor,
                    n_experts: int, capacity: int, out_dtype: torch.dtype,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of kernel B4a: ``expert_in[e, c] = scale_t *
    x_t`` for the kept token with ``choice_t = e, pos_t = c``, zeros
    elsewhere, in ``out_dtype`` (each element one fp32 product, then one
    conversion; ``scale=None`` copies the row). ``x [T, D]`` ->
    ``[E, capacity, D]``. Dropped tokens write a spare row that is cut
    off."""
    d = x.shape[1]
    slots = n_experts * capacity
    keep = _kept(choice, pos, n_experts, capacity)
    index = torch.where(keep, choice * capacity + pos, slots)
    if scale is not None:
        x = x.float() * scale.float()[:, None]
    out = torch.zeros((slots + 1, d), dtype=out_dtype, device=x.device)
    out.index_put_((index,), x.to(out_dtype))
    return out[:slots].reshape(n_experts, capacity, d)


def _plain_combine(expert_out: torch.Tensor, choice: torch.Tensor,
                   pos: torch.Tensor, gate: Optional[torch.Tensor],
                   capacity: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version of kernel B4b: ``out_t = gate_t *
    expert_out[choice_t, pos_t]`` for kept tokens (one fp32 product,
    then one conversion to ``out_dtype``), an exact zero row for dropped
    ones; ``gate=None`` copies the row. ``expert_out [E, capacity, D]`` ->
    ``[T, D]``."""
    e, c, d = expert_out.shape
    keep = _kept(choice, pos, e, capacity)
    slot = torch.where(keep, choice * c + pos, 0)
    rows = expert_out.reshape(e * c, d)[slot].float()
    if gate is not None:
        rows = rows * gate.float()[:, None]
    return torch.where(keep[:, None], rows, 0.0).to(out_dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = {F32: 0, BF16: 1}
#: (input type, output type) pairs each kernel takes, each with or without
#: its per-token fp32 factor (dispatch's ``scale``, combine's ``gate``).
#: Combine's backward dispatches its cotangent (combine's output type)
#: into combine's input type
DISPATCH_TYPES = frozenset({(BF16, BF16), (F32, BF16), (F32, F32)})
COMBINE_TYPES = frozenset({(BF16, BF16), (BF16, F32), (F32, F32)})
#: elements of one chunk of the kernels' vector path: 16 bytes of bf16,
#: two 16-byte accesses of fp32
VECTOR = 8


def vector_path(dim: int, *rows: torch.Tensor) -> bool:
    """Whether a B4 launch over rows of ``dim`` elements takes the
    kernel's 16-byte path: ``dim`` a whole number of chunks and the data
    of every row operand (input and output) 16-byte aligned. Otherwise
    the same kernel takes its scalar path."""
    return dim % VECTOR == 0 and all(t.data_ptr() % 16 == 0 for t in rows)


def _routing_operands(choice: torch.Tensor, pos: torch.Tensor, tokens: int,
                      device: torch.device):
    for name, t in (("choice", choice), ("pos", pos)):
        if (t.dtype != torch.int64 or tuple(t.shape) != (tokens,)
                or t.device != device):
            raise ValueError("moe kernel %s must be int64 [%d] on %s, got %s "
                             "%r on %s" % (name, tokens, device, t.dtype,
                                           tuple(t.shape), t.device))
    return choice.contiguous(), pos.contiguous()


def _token_factor(kernel: str, name: str, v: Optional[torch.Tensor],
                  tokens: int, device: torch.device
                  ) -> Optional[torch.Tensor]:
    """An fp32 ``[tokens]`` factor made contiguous, or None."""
    if v is None:
        return None
    if v.dtype != F32 or tuple(v.shape) != (tokens,) or v.device != device:
        raise ValueError("%s %s must be fp32 [%d] on %s, got %s %r on %s"
                         % (kernel, name, tokens, device, v.dtype,
                            tuple(v.shape), v.device))
    return v.contiguous()


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check_types(kernel: str, pairs, in_dtype: torch.dtype,
                 out_dtype: torch.dtype) -> None:
    if (in_dtype, out_dtype) not in pairs:
        raise TypeError("%s takes %s, got %s -> %s" % (
            kernel, ", ".join(sorted("%s -> %s" % p for p in pairs)),
            in_dtype, out_dtype))


def _check_sizes(n_experts: int, capacity: int, dim: int) -> None:
    if n_experts < 1 or capacity < 1 or dim < 1:
        raise ValueError("moe kernels take at least one expert, slot and "
                         "feature, got E=%d C=%d D=%d"
                         % (n_experts, capacity, dim))


def _call(fn_name: str, argtypes, args, vec: bool,
          device: torch.device) -> None:
    """Launch ``moe_<fn_name>`` of ``csrc/moe.cu`` on the current stream
    of ``device`` (``vec``: its 16-byte path); raises on a non-zero CUDA
    error code."""
    fn = getattr(_kernels.load("moe"), "moe_" + fn_name)
    fn.argtypes = list(argtypes) + [_I, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, int(vec), stream)
    if err != 0:
        raise RuntimeError("moe_%s kernel launch failed: CUDA error %d"
                           % (fn_name, err))
    moe_apply_fused.launches[fn_name] += 1
    moe_apply_fused.path_launches[
        "%s_%s" % (fn_name, "vector" if vec else "scalar")] += 1


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _launch_dispatch(x: torch.Tensor, choice: torch.Tensor, pos: torch.Tensor,
                     n_experts: int, capacity: int, out_dtype: torch.dtype,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B4a: ``x [T, D]`` -> ``[E, capacity, D]`` in ``out_dtype``,
    each kept row times ``scale`` (fp32 ``[T]``) or, with None, copied.
    Two device operations: the slot table's build (into scratch that is
    never cleared: the gather checks each entry), then the gather that
    writes every output row once."""
    if x.dim() != 2:
        raise ValueError("moe_dispatch takes x [T, D], got %r"
                         % (tuple(x.shape),))
    _check_types("moe_dispatch", DISPATCH_TYPES, x.dtype, out_dtype)
    t, d = x.shape
    _check_sizes(n_experts, capacity, d)
    choice, pos = _routing_operands(choice, pos, t, x.device)
    scale = _token_factor("moe_dispatch", "scale", scale, t, x.device)
    table = torch.empty(n_experts * capacity, dtype=torch.int32,
                        device=x.device)
    out = torch.empty((n_experts, capacity, d), dtype=out_dtype,
                      device=x.device)
    _dispatch_into(x.contiguous(), choice, pos, scale, table, out)
    return out


def _dispatch_into(x: torch.Tensor, choice: torch.Tensor, pos: torch.Tensor,
                   scale: Optional[torch.Tensor], table: torch.Tensor,
                   out: torch.Tensor) -> None:
    """The launch of :func:`_launch_dispatch` on operands it has checked:
    contiguous ``x``, routing and ``scale``, the slot table (int32
    ``[E * C]``, any content) and ``out [E, C, D]``."""
    (t, d), (n_experts, capacity, _) = x.shape, out.shape
    _call("dispatch", (_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _LL, _I, _I),
          (x.data_ptr(), choice.data_ptr(), pos.data_ptr(), _ptr(scale),
           table.data_ptr(), out.data_ptr(), t, d, n_experts, capacity,
           _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[out.dtype]),
          vector_path(d, x, out), x.device)


def _launch_combine(expert_out: torch.Tensor, choice: torch.Tensor,
                    pos: torch.Tensor, gate: Optional[torch.Tensor],
                    capacity: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel B4b: ``expert_out [E, capacity, D]`` -> ``[T, D]`` in
    ``out_dtype``; ``gate`` is fp32 ``[T]`` or None (no product)."""
    if expert_out.dim() != 3 or expert_out.shape[1] != capacity:
        raise ValueError("moe_combine takes expert_out [E, %d, D], got %r"
                         % (capacity, tuple(expert_out.shape)))
    _check_types("moe_combine", COMBINE_TYPES, expert_out.dtype, out_dtype)
    e, _, d = expert_out.shape
    _check_sizes(e, capacity, d)
    t = choice.shape[0]
    dev = expert_out.device
    choice, pos = _routing_operands(choice, pos, t, dev)
    gate = _token_factor("moe_combine", "gate", gate, t, dev)
    expert_out = expert_out.contiguous()
    out = torch.empty((t, d), dtype=out_dtype, device=dev)
    _call("combine", (_P, _P, _P, _P, _P, _LL, _LL, _I, _LL, _I, _I),
          (expert_out.data_ptr(), choice.data_ptr(), pos.data_ptr(),
           _ptr(gate), out.data_ptr(), t, d, e, capacity,
           _KERNEL_DTYPES[expert_out.dtype], _KERNEL_DTYPES[out_dtype]),
          vector_path(d, expert_out, out), dev)
    return out


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("moe kernels run on cuda or cpu tensors, got %s"
                         % x.device)
    return x.device.type


def dispatch(x: torch.Tensor, choice: torch.Tensor, pos: torch.Tensor,
             n_experts: int, capacity: int,
             out_dtype: Optional[torch.dtype] = None,
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token rows ``x [T, D]`` into expert slots ``[E, capacity, D]``
    (``out_dtype`` defaults to x's), each times ``scale`` (fp32 ``[T]``;
    None: no product): kernel B4a for CUDA tensors, counted in
    ``moe_apply_fused.launches["dispatch"]``; the plain version for CPU
    tensors. Not differentiable (see :func:`moe_apply_fused`)."""
    out_dtype = out_dtype or x.dtype
    if _device_of(x) == "cpu":
        return _plain_dispatch(x, choice, pos, n_experts, capacity, out_dtype,
                               scale)
    return _launch_dispatch(x, choice, pos, n_experts, capacity, out_dtype,
                            scale)


def combine(expert_out: torch.Tensor, choice: torch.Tensor,
            pos: torch.Tensor, gate: Optional[torch.Tensor], capacity: int,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Expert rows back to tokens, ``[T, D]``, times ``gate`` (None: no
    product), zeros for dropped tokens: kernel B4b for CUDA tensors,
    counted in ``moe_apply_fused.launches["combine"]``; the plain version
    for CPU tensors. Not differentiable."""
    out_dtype = out_dtype or expert_out.dtype
    if _device_of(expert_out) == "cpu":
        return _plain_combine(expert_out, choice, pos, gate, capacity,
                              out_dtype)
    return _launch_combine(expert_out, choice, pos, gate, capacity, out_dtype)


# ---------------------------------------------------------------------------
# differentiable dispatch / combine
# ---------------------------------------------------------------------------

class _Dispatch(torch.autograd.Function):
    """``expert_in[e, c] = sum_t 1[choice_t = e, pos_t = c < capacity] x_t``
    in x's type. Linear in x given the routing, so the backward is the
    combine kernel with no gate: ``dx_t = g[choice_t, pos_t]``."""

    @staticmethod
    def forward(ctx, x, choice, pos, n_experts: int, capacity: int):
        ctx.save_for_backward(choice, pos)
        ctx.capacity = capacity
        return dispatch(x, choice, pos, n_experts, capacity)

    @staticmethod
    def backward(ctx, g):
        choice, pos = ctx.saved_tensors
        dx = combine(g, choice, pos, None, ctx.capacity)
        return dx, None, None, None, None


class _Combine(torch.autograd.Function):
    """``out_t = gate_t * expert_out[choice_t, pos_t]`` (zero for dropped
    tokens) in ``out_dtype``. Backward, the reference's function: the
    cotangent for ``expert_out`` is the dispatch of ``dout32 * gate``
    into expert_out's type, fused: the dispatch kernel reads ``dout`` in
    its own type and takes the gate as its scale (``dout`` to fp32 is
    exact, and the one fp32 product and one conversion are the same, so
    the bits are too); the gate's is the rowwise dot of ``dout32`` with
    the ungated combine, written in fp32."""

    @staticmethod
    def forward(ctx, expert_out, gate, choice, pos, capacity: int,
                out_dtype: torch.dtype):
        ctx.save_for_backward(expert_out, gate, choice, pos)
        ctx.capacity = capacity
        return combine(expert_out, choice, pos, gate, capacity, out_dtype)

    @staticmethod
    def backward(ctx, dout):
        expert_out, gate, choice, pos = ctx.saved_tensors
        d_eo = dgate = None
        if ctx.needs_input_grad[0]:
            d_eo = dispatch(dout, choice, pos, expert_out.shape[0],
                            ctx.capacity, expert_out.dtype, scale=gate)
        if ctx.needs_input_grad[1]:
            ungated = combine(expert_out, choice, pos, None, ctx.capacity,
                              F32)
            dgate = torch.sum(dout.float() * ungated, dim=-1)
        return d_eo, dgate, None, None, None, None


def moe_apply_fused(params: Dict, x: torch.Tensor,
                    capacity_factor: float = 1.25, dtype: torch.dtype = BF16,
                    split: Optional[Split] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """The fused twin of :func:`moe_apply`: the same routing and expert
    MLP, with dispatch and combine as kernels B4a/B4b that never build the
    ``[T, E, C]`` tensors, over this rank's experts. Differentiable end
    to end, router gate included. CUDA tensors launch the kernels
    (forward and backward, each launch counted in
    ``moe_apply_fused.launches``); CPU tensors run their plain
    versions."""
    if split is None:
        split = collectives.moe_split()
    b, s, d = x.shape
    gate, choice, pos, capacity, aux = _route(params, x, capacity_factor,
                                              split)
    first, n, group = _local_experts(params, split)
    local = choice - first
    xf = collectives.sum_backward(x.reshape(b * s, d).to(dtype), group)
    gate = collectives.sum_backward(gate, group)
    expert_in = _Dispatch.apply(xf, local, pos, n, capacity)
    expert_out = _experts(params, expert_in, dtype)
    out = _Combine.apply(expert_out, gate, local, pos, capacity, dtype)
    out = collectives.sum_forward(out, group)
    return out.reshape(b, s, d), aux


#: kernel launches since the last reset, by kernel (chip_smoke.py reads it)
moe_apply_fused.launches = {"dispatch": 0, "combine": 0}
#: the same launches by the kernel's path (:func:`vector_path`)
moe_apply_fused.path_launches = {"dispatch_vector": 0, "dispatch_scalar": 0,
                                 "combine_vector": 0, "combine_scalar": 0}
