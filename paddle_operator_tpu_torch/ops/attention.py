"""Paged decode attention: the counterpart of the paged part of
``paddle_operator_tpu/ops/attention_pallas.py``.

Serving decode is ONE query token per sequence against a KV history
scattered across fixed-size cache pages (:mod:`..serving.kv_cache`, the
vLLM layout). :func:`paged_decode_attention` launches the hand-written
CUDA kernel ``csrc/paged_decode.cu`` for CUDA tensors and uses
:func:`_reference_paged_decode`, the plain gather-einsum version, only for
tensors on the CPU. On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from . import _kernels

NEG_INF = -1e30


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
        if x.dtype != torch.float32:
            raise TypeError("paged decode kernel takes fp32 %s, got %s"
                            % (name, x.dtype))
    tensors = (q, k_pages, v_pages, block_tables, seq_lens)
    if any(x.device != q.device for x in tensors):
        raise ValueError("paged decode inputs lie on different devices: %s"
                         % [str(x.device) for x in tensors])
    q = q.contiguous()
    k_pages = k_pages.contiguous()
    v_pages = v_pages.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _kernels.load("paged_decode")
    fn = lib.paged_decode_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 b, h, d, block_size, tables.shape[1], float(scale), stream)
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
    ``[B]`` int32 tokens live in each sequence's cache, at least 1.
    Returns the attention context ``[B, H, D]`` in ``q.dtype``.

    CUDA tensors go through the hand-written kernel (fp32 only) and add
    one to ``paged_decode_attention.launches``; CPU tensors go through
    :func:`_reference_paged_decode`. Inference only: no autograd.
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
