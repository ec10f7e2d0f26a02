"""Attention kernels of the port: the counterpart of
``paddle_operator_tpu/ops/attention_pallas.py``, flash part and paged part.

Flash attention (training): :func:`flash_attention` and
:func:`flash_attention_lse` take ``[B, H, S, D]`` q/k/v and are
differentiable through one ``torch.autograd.Function``, the counterpart of
the reference's ``jax.custom_vjp``s. For CUDA tensors the forward launches
kernel B2a and the backward kernels B2b (dQ) and B2c (dK/dV), all three in
the hand-written ``csrc/flash_attention.cu`` (on bf16 all three run on
the tensor cores; ``testing.mma_flash_fwd``, ``mma_flash_dq`` and
``mma_flash_dkv`` model their rounding); CPU tensors take the plain
versions beside them
(:func:`_plain_flash_fwd`, :func:`_plain_flash_dq`,
:func:`_plain_flash_dkv`), which materialise the scores in fp32. On a
CUDA tensor the wrappers launch the kernel or raise.

Paged decode (serving): one query token per sequence against a KV history
scattered across fixed-size cache pages (:mod:`..serving.kv_cache`, the
vLLM layout). Its kernel reports no FLOPs to ``FlopCounterMode`` (its
plain version's einsums are counted there); serving has no hardware
plane. :func:`paged_decode_attention` launches the hand-written
CUDA kernel ``csrc/paged_decode.cu`` (fp32 or bf16 q and pages, split over
pages, then merged) for CUDA tensors and uses
:func:`_reference_paged_decode`, the plain gather-einsum version, only for
tensors on the CPU. On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from . import _kernels

NEG_INF = -1e30
# the reference tiles its kernels by multiples of this (its lane width);
# block_q/block_k are checked against it so that a call valid there is
# valid here
MIN_BLOCK = 128


# ---------------------------------------------------------------------------
# flash attention: plain versions
# ---------------------------------------------------------------------------

def _reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool = False) -> torch.Tensor:
    """Plain einsum attention in BHSD, fp32 softmax, probabilities cast to
    the input type before the product with v."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        scores = _causal_mask(scores)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _causal_mask(s: torch.Tensor) -> torch.Tensor:
    """NEG_INF above the diagonal of square scores [..., S, S]."""
    n = s.shape[-1]
    keep = torch.tril(torch.ones((n, n), dtype=torch.bool, device=s.device))
    return torch.where(keep, s, NEG_INF)


def _plain_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, causal: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel B2a: ``(O, LSE)`` from materialised
    scores, in fp32, with the kernel's scaling order (q is scaled before
    the product) and its normalisation (``O = (P v) / l`` with
    ``P = exp(s - m)``). O has q's type, LSE is ``[B, H, S]`` fp32."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        s = _causal_mask(s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _plain_probs(q, k, lse, scale, causal) -> torch.Tensor:
    """``P = exp(scale * q k^T - LSE)`` in fp32, the backward kernels'
    recomputation (the product is scaled, not q)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = _causal_mask(s)
    return torch.exp(s - lse[..., None])


def _plain_ds(p, v, dout, delta) -> torch.Tensor:
    return p * (torch.matmul(dout.float(), v.float().transpose(-1, -2))
                - delta[..., None])


def _plain_flash_dq(q, k, v, dout, lse, delta, scale: float,
                    causal: bool) -> torch.Tensor:
    """The plain version of kernel B2b: ``dQ = scale * dS k`` with
    ``dS = P * (dO v^T - delta)``, in fp32, returned in q's type."""
    ds = _plain_ds(_plain_probs(q, k, lse, scale, causal), v, dout, delta)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def _plain_flash_dkv(q, k, v, dout, lse, delta, scale: float,
                     causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel B2c: ``dK = scale * dS^T q`` and
    ``dV = P^T dO``, in fp32, returned in k's and v's types."""
    p = _plain_probs(q, k, lse, scale, causal)
    ds = _plain_ds(p, v, dout, delta)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# flash attention: kernel launches
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (a misaligned view is copied)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _kernel_operand(x: torch.Tensor, name: str, like: torch.Tensor
                    ) -> torch.Tensor:
    """``x`` as the kernels take it: ``like``'s shape, type and device."""
    if x.device != like.device:
        raise ValueError("flash attention operand %s lies on %s, q on %s"
                         % (name, x.device, like.device))
    if x.dtype != like.dtype or x.shape != like.shape:
        raise ValueError("flash attention operand %s is %s %r, q is %s %r"
                         % (name, x.dtype, tuple(x.shape), like.dtype,
                            tuple(like.shape)))
    return _aligned(x)


def _kernel_rows(x: torch.Tensor, name: str, like: torch.Tensor
                 ) -> torch.Tensor:
    """An fp32 ``[B, H, S]`` per-row operand (LSE, delta) on ``like``'s
    device, as the kernels take it."""
    if (tuple(x.shape) != tuple(like.shape[:3]) or x.dtype != torch.float32
            or x.device != like.device):
        raise ValueError("flash attention %s must be fp32 %r on %s, got %s "
                         "%r on %s" % (name, tuple(like.shape[:3]),
                                       like.device, x.dtype, tuple(x.shape),
                                       x.device))
    return _aligned(x)


def _check_kernel_shape(q: torch.Tensor) -> None:
    """The kernels take what the reference's flash_attention takes: S a
    multiple of 128 (a whole number of their tiles) and D in (64, 128,
    256); ``supports``' S >= 256 is mha's rule, not the kernels'."""
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError("flash attention kernels take fp32 or bf16, got %s"
                        % q.dtype)
    if q.dim() != 4 or q.shape[2] % MIN_BLOCK or q.shape[2] == 0 \
            or q.shape[3] not in (64, 128, 256):
        raise ValueError(
            "flash attention kernels take [B, H, S, D] with S %% 128 == 0 "
            "and D in (64, 128, 256), got %r" % (tuple(q.shape),))


def _call(fn_name: str, pointers, q: torch.Tensor, scale: float,
          causal: bool) -> None:
    """Launch ``flash_attention_<fn_name>`` of ``csrc/flash_attention.cu``
    on the current stream of q's device: the tensor pointers, then
    ``bh, s, d, dtype, scale, causal, stream``. Raises on a non-zero CUDA
    error code."""
    fn = getattr(_kernels.load("flash_attention"), "flash_attention_"
                 + fn_name)
    fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    b, h, s, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(x.data_ptr() for x in pointers), b * h, s, d,
                 _KERNEL_DTYPES[q.dtype], float(scale), int(causal), stream)
    if err != 0:
        raise RuntimeError("flash_attention_%s kernel launch failed: CUDA "
                           "error %d" % (fn_name, err))
    flash_attention.launches[fn_name] += 1


def _launch_fwd(q, k, v, scale: float, causal: bool):
    _check_kernel_shape(q)
    q = _aligned(q)
    k = _kernel_operand(k, "k", q)
    v = _kernel_operand(v, "v", q)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _call("fwd", (q, k, v, out, lse), q, scale, causal)
    return out, lse


def _backward_operands(q, k, v, dout, lse, delta):
    _check_kernel_shape(q)
    q = _aligned(q)
    return (q, _kernel_operand(k, "k", q), _kernel_operand(v, "v", q),
            _kernel_operand(dout, "dout", q), _kernel_rows(lse, "lse", q),
            _kernel_rows(delta, "delta", q))


def _launch_dq(q, k, v, dout, lse, delta, scale: float, causal: bool):
    operands = _backward_operands(q, k, v, dout, lse, delta)
    dq = torch.empty_like(operands[0])
    _call("dq", (*operands, dq), operands[0], scale, causal)
    return dq


def _launch_dkv(q, k, v, dout, lse, delta, scale: float, causal: bool):
    operands = _backward_operands(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(operands[1]), torch.empty_like(operands[2])
    _call("dkv", (*operands, dk, dv), operands[0], scale, causal)
    return dk, dv


def _on(x: torch.Tensor, plain, kernel, *args):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return plain(*args)
    if x.device.type != "cuda":
        raise ValueError("flash attention runs on cuda or cpu tensors, got "
                         "%s" % x.device)
    return kernel(*args)


# The three calls are operators of their own (``torch.ops.
# paddle_tpu_torch.flash_{fwd,dq,dkv}``, CPU and CUDA kernels), so that
# ``torch.utils.flop_counter.FlopCounterMode`` sees them: it cannot see
# into a ctypes launch, and counts each operator by its formula below in
# place of whatever its body runs. Kernel and plain version therefore
# count the same FLOPs, and a step counts the same whichever ran.
_LIB = torch.library.Library("paddle_tpu_torch", "DEF")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, float scale, "
            "bool causal) -> (Tensor, Tensor)")
_LIB.define("flash_dq(Tensor q, Tensor k, Tensor v, Tensor dout, "
            "Tensor lse, Tensor delta, float scale, bool causal) -> Tensor")
_LIB.define("flash_dkv(Tensor q, Tensor k, Tensor v, Tensor dout, "
            "Tensor lse, Tensor delta, float scale, bool causal) "
            "-> (Tensor, Tensor)")


def _fwd_op(q, k, v, scale, causal):
    return _on(q, _plain_flash_fwd, _launch_fwd, q, k, v, scale, causal)


def _dq_op(q, k, v, dout, lse, delta, scale, causal):
    return _on(q, _plain_flash_dq, _launch_dq, q, k, v, dout, lse, delta,
               scale, causal)


def _dkv_op(q, k, v, dout, lse, delta, scale, causal):
    return _on(q, _plain_flash_dkv, _launch_dkv, q, k, v, dout, lse, delta,
               scale, causal)


for _name, _fn in (("flash_fwd", _fwd_op), ("flash_dq", _dq_op),
                   ("flash_dkv", _dkv_op)):
    for _key in ("CPU", "CUDA"):
        _LIB.impl(_name, _fn, _key)


def attention_pairs(s: int, causal: bool) -> int:
    """The (query, key) pairs attention computes at sequence length
    ``s``: all S^2, or the S(S+1)/2 on and below the diagonal."""
    return s * (s + 1) // 2 if causal else s * s


def flash_flops(kernel: str, q_shape: Sequence[int], causal: bool) -> int:
    """Model FLOPs of one call of flash ``kernel`` (``fwd``, ``dq``,
    ``dkv``) on ``[B, H, S, D]``: two products of 2*D FLOPs a live
    (query, key) pair each, Q K^T and P V forward, dO V^T and dS K for
    dQ, P^T dO and dS^T Q for dK/dV. The backward's recompute of the
    scores is not counted (MFU's convention), and causal attention counts
    the pairs it keeps. Non-causal, the forward's count is the one
    ``FlopCounterMode`` gives ``_plain_flash_fwd``, and the three
    together the one it gives the einsum attention's forward and
    backward; the three together are the 12 D pairs a head of
    ``chip_smoke.py``'s hand count."""
    if kernel not in ("fwd", "dq", "dkv"):
        raise ValueError("no flash kernel %r" % kernel)
    b, h, s, d = q_shape
    return 4 * b * h * d * attention_pairs(s, causal)


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import flop_registry, \
        register_flop_formula

    def formula(kernel):
        def count(q_shape, *args, out_shape=None, **kwargs) -> int:
            return flash_flops(kernel, q_shape, bool(args[-1]))
        return count

    for kernel in ("fwd", "dq", "dkv"):
        op = getattr(torch.ops.paddle_tpu_torch, "flash_" + kernel)
        if op not in flop_registry:
            register_flop_formula(op)(formula(kernel))


_register_flop_formulas()


class _FlashAttention(torch.autograd.Function):
    """(O, LSE), both differentiable; an unused output's cotangent stays
    None."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        ctx.set_materialize_grads(False)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, scale,
                                                        causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        """dq, dk, dv: delta = rowsum(dO * O) in fp32, outside the kernels
        as in the reference; an LSE cotangent folds into it (d LSE /
        d scores = P, so ``dS = P * (dO v^T - (delta - g_lse))``)."""
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        delta = torch.sum(g_out.float() * out.float(), dim=-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        args = (q, k, v, g_out, lse, delta, ctx.scale, ctx.causal)
        dq = torch.ops.paddle_tpu_torch.flash_dq(*args)
        dk, dv = torch.ops.paddle_tpu_torch.flash_dkv(*args)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# flash attention: entry points
# ---------------------------------------------------------------------------

def supports(q_shape: Sequence[int], dtype: Optional[torch.dtype] = None
             ) -> bool:
    """Kernel applicability (the reference's predicate): ``[B, H, S, D]``
    with S >= 256, S a multiple of 128 and D in {64, 128, 256}."""
    if len(q_shape) != 4:
        return False
    _, _, s, d = q_shape
    return s >= 256 and s % 128 == 0 and d in (64, 128, 256)


def _check_blocks(q_shape: Sequence[int], block_q: int, block_k: int
                  ) -> None:
    if block_q % MIN_BLOCK or block_k % MIN_BLOCK:
        raise ValueError(
            "block_q/block_k must be multiples of %d, got %d/%d"
            % (MIN_BLOCK, block_q, block_k))
    s = q_shape[2]
    if s % block_q or s % block_k:
        raise ValueError(
            "seq len %d must divide block_q=%d and block_k=%d"
            % (s, block_q, block_k))


def _prepare(q, k, v, scale, block_q, block_k):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError("flash attention takes q, k, v of one [B, H, S, D] "
                         "shape, got %r %r %r" % (tuple(q.shape),
                                                  tuple(k.shape),
                                                  tuple(v.shape)))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    # the reference's auto block is a multiple of 128 that divides S, so a
    # None block is valid exactly when 128 is
    _check_blocks(q.shape, block_q or MIN_BLOCK, block_k or MIN_BLOCK)
    return float(scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v: ``[B, H, S, D]`` -> ``[B, H, S, D]``. Differentiable.

    ``block_q``/``block_k`` are checked as the reference checks them
    (multiples of 128 that divide S; None is its auto size), so a call
    valid in the JAX package is valid here; the CUDA kernels pick their
    own tiles (64 rows a block; ``csrc/flash_attention.cu``) and the plain
    versions need none. CUDA tensors (fp32 or bf16, ``supports`` shapes)
    run kernel B2a forward and B2b/B2c backward, counted in
    ``flash_attention.launches``; CPU tensors run the plain versions."""
    return flash_attention_lse(q, k, v, scale, block_q, block_k, causal)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention`, and also the per-row log-sum-exp
    (``[B, H, S]`` fp32), the quantity that merges independently computed
    attention blocks exactly. Differentiable in both outputs: the LSE's
    cotangent folds into delta."""
    scale = _prepare(q, k, v, scale, block_q, block_k)
    return _FlashAttention.apply(q, k, v, scale, causal)


#: kernel launches since the last reset, by kernel (chip_smoke.py reads it)
flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------


def _reference_paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            seq_lens: torch.Tensor, scale: float
                            ) -> torch.Tensor:
    """Gather-then-einsum reference: q [B,H,D], pages [P,bs,H,D],
    block_tables [B,T] int, seq_lens [B] int -> [B,H,D]. fp32 softmax,
    the same math as the kernel up to summation order."""
    bs = k_pages.shape[1]
    b, h, d = q.shape
    t = block_tables.shape[1]
    idx = block_tables.long()
    k = k_pages[idx].reshape(b, t * bs, h, d)            # [B, T*bs, H, D]
    v = v_pages[idx].reshape(b, t * bs, h, d)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    valid = (torch.arange(t * bs, device=q.device)[None, :]
             < seq_lens.to(q.device)[:, None])           # [B, T*bs]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v.float()).to(q.dtype)


def supports_paged(q_shape: Sequence[int], block_size: int) -> bool:
    """Kernel applicability for decode: [B, H, D] single-token queries,
    head_dim in {64, 128, 256}, page size a multiple of 8."""
    if len(q_shape) != 3:
        return False
    _, _, d = q_shape
    return d in (64, 128, 256) and block_size % 8 == 0


#: about how many tokens one block of the paged-decode kernel's first pass
#: takes, in whole pages (``paged_split``; ``kSplitTokens`` of
#: ``csrc/paged_decode.cu``, which sizes its page-id buffer by it)
PAGED_SPLIT_TOKENS = 128


def paged_split(block_size: int, pages_per_seq: int) -> Tuple[int, int]:
    """``(pages, splits)``: the paged-decode kernel spreads each (head,
    sequence) over ``splits`` blocks of ``pages`` pages each, from the page
    size and the table's width alone (never from ``seq_lens``, which would
    need a device-to-host sync)."""
    pages = max(1, PAGED_SPLIT_TOKENS // block_size)
    return pages, -(-pages_per_seq // pages)


def _launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
            block_tables: torch.Tensor, seq_lens: torch.Tensor,
            scale: float) -> torch.Tensor:
    b, h, d = q.shape
    block_size = k_pages.shape[1]
    if not supports_paged(q.shape, block_size):
        raise ValueError(
            "paged decode kernel takes head_dim in (64, 128, 256) and a "
            "page size divisible by 8, got head_dim %d, page size %d"
            % (d, block_size))
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.dtype not in _KERNEL_DTYPES:
            raise TypeError("paged decode kernel takes fp32 or bf16 %s, got "
                            "%s" % (name, x.dtype))
    if v_pages.dtype != k_pages.dtype:
        raise TypeError("paged decode kernel takes k_pages and v_pages of "
                        "one type, got %s and %s"
                        % (k_pages.dtype, v_pages.dtype))
    tensors = (q, k_pages, v_pages, block_tables, seq_lens)
    if any(x.device != q.device for x in tensors):
        raise ValueError("paged decode inputs lie on different devices: %s"
                         % [str(x.device) for x in tensors])
    t = block_tables.shape[1]
    if t == 0:
        raise ValueError("paged decode kernel takes a table of at least one "
                         "page")
    pages, splits = paged_split(block_size, t)
    q, k_pages, v_pages = _aligned(q), _aligned(k_pages), _aligned(v_pages)
    tables = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    # each split's partial state: m and l, then acc[D], fp32
    part = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    fn = _kernels.load("paged_decode").paged_decode
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), part.data_ptr(),
                 out.data_ptr(), b, h, d, block_size, t, pages, splits,
                 _KERNEL_DTYPES[q.dtype], _KERNEL_DTYPES[k_pages.dtype],
                 float(scale), stream)
    if err != 0:
        raise RuntimeError("paged_decode kernel launch failed: CUDA error %d"
                           % err)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over a paged KV cache.

    q: ``[B, H, D]`` (one new query token per sequence) -- k_pages /
    v_pages: ``[P, bs, H, D]`` page pools -- block_tables: ``[B, T]``
    int32 page ids per sequence (entries past the sequence's pages may be
    any valid id; their tokens are masked by ``seq_lens``) -- seq_lens:
    ``[B]`` int32 tokens live in each sequence's cache. Positions at or
    past a length score ``NEG_INF``, as in the reference: a length of 0
    gives the mean of V over all ``T * bs`` slots of the table, a length
    above ``T * bs`` counts as ``T * bs``. Scores, softmax and sums are
    fp32; returns the attention context ``[B, H, D]`` in ``q.dtype``.

    CUDA tensors (q fp32 or bf16, the pools fp32 or bf16) go through the
    hand-written kernel (two CUDA kernels: a pass split over pages and a
    merge) and add one to ``paged_decode_attention.launches`` a call; CPU
    tensors go through :func:`_reference_paged_decode`. Inference only: no
    autograd.
    """
    b, h, d = q.shape
    _, _, kh, kd = k_pages.shape
    if (kh, kd) != (h, d) or v_pages.shape != k_pages.shape:
        raise ValueError(
            "page pools %r/%r do not match q heads/dim %r"
            % (tuple(k_pages.shape), tuple(v_pages.shape), (h, d)))
    if block_tables.shape[0] != b or tuple(seq_lens.shape) != (b,):
        raise ValueError(
            "block_tables %r / seq_lens %r do not cover batch %d"
            % (tuple(block_tables.shape), tuple(seq_lens.shape), b))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _reference_paged_decode(q, k_pages, v_pages, block_tables,
                                       seq_lens, scale)
    if q.device.type != "cuda":
        raise ValueError("paged_decode_attention runs on cuda or cpu "
                         "tensors, got %s" % q.device)
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, scale)


#: kernel launches since the last reset (chip_smoke.py reads it)
paged_decode_attention.launches = 0
