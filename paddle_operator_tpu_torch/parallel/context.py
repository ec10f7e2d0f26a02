"""Sequence parallelism: ring and Ulysses attention over the ``sp`` axis
of a mesh of processes, the port of ``paddle_operator_tpu/parallel/
context.py``, function by function.

* :func:`ring_attention`: each rank holds a block of the sequence of Q/K/V,
  and the K/V blocks travel around the ``sp`` ring (:func:`.collectives.
  ring_shift`, the reference's ``lax.ppermute``), one hop a step. With
  ``impl="blockwise"`` each hop is an online-softmax update
  (:func:`_block_update`) recomputed in the backward
  (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``); with
  the flash path (:func:`ring_flash_attention`) each hop runs the
  flash-attention kernels through :func:`..ops.attention.
  flash_attention_lse` and the hops merge by their log-sum-exp.
* :func:`ulysses_attention`: two all-to-alls (:func:`.collectives.
  all_to_all`) re-shard [sequence-split, all heads] to [whole sequence,
  heads split], attention runs locally per head group, and the output
  swaps back.

**One deliberate difference from the reference: there are no global
arrays.** The reference's functions take the global ``[B, H, S, D]``
arrays and do the ``shard_map`` plumbing inside. Here each function takes
this rank's block ``[B, H, S/n, D]`` (rank i of the axis holds tokens
``[i S/n, (i+1) S/n)``; :func:`local_block` cuts it from a global
tensor) and the :class:`.mesh.Mesh`, and returns this rank's block of
the output. So the reference's check that S divides by n lives in
:func:`local_block`. All functions are differentiable; every rank of
the axis must call them in the same order (they run collectives).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import attention
from . import collectives
from .mesh import Mesh

NEG_INF = -1e30


def local_block(x: torch.Tensor, mesh: Mesh, axis: str = "sp",
                dim: int = 2) -> torch.Tensor:
    """This rank's block of the global ``x`` along ``dim`` (the sequence
    axis of BHSD), for the ring over ``axis``."""
    n, i = mesh.axis_size(axis), mesh.axis_rank(axis)
    s = x.shape[dim]
    if s % n:
        raise ValueError("seq len %d must divide ring size %d" % (s, n))
    return x.narrow(dim, i * (s // n), s // n)


def _block_update(q, k, v, acc, m, l, q_pos, k_pos, scale: float,
                  causal: bool):
    """One flash-attention accumulation step of local Q against one KV
    block.

    q: [B,H,Sq,D]  k,v: [B,H,Sk,D]  acc: [B,H,Sq,D] fp32; m, l: [B,H,Sq]
    fp32 running max / denominator; q_pos/k_pos: [Sq]/[Sk] global token
    positions for causal masking."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]            # [Sq, Sk]
        scores = torch.where(mask, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # guard fully-masked rows: clamp m above -inf territory so the exps
    # below underflow to 0.0 instead of producing inf - inf = nan
    m_safe = torch.clamp(m_new, min=NEG_INF / 2)
    p = torch.exp(scores - m_safe[..., None])               # [B,H,Sq,Sk]
    correction = torch.exp(m - m_safe)
    l_new = l * correction + p.sum(dim=-1)
    acc_new = acc * correction[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v.float())
    return acc_new, m_safe, l_new


def _softmax_state(q: torch.Tensor):
    """The online softmax's start: acc 0, m NEG_INF, l 0, in fp32."""
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device))


def _shift_kv(k: torch.Tensor, v: torch.Tensor, group):
    """K and V one hop on around the ring, in one transfer."""
    return collectives.ring_shift(torch.stack((k, v)), group).unbind(0)


def _invisible(src: int, my: int) -> bool:
    """Under causal attention, the block born on ring position ``src``
    is invisible to this rank's queries when ``src`` is not earlier than
    ``my`` (hops 1..n-1 only: ``src != my`` there)."""
    return src >= my


def _axis(mesh: Mesh, axis: str):
    """``(size, this rank's index, group)`` of ``axis``; an axis above 1
    needs a process group (a mesh built outside one has none)."""
    n, group = mesh.axis_size(axis), mesh.axis_group(axis)
    if n > 1 and group is None:
        raise ValueError("mesh axis %r of size %d has no process group"
                         % (axis, n))
    return n, mesh.axis_rank(axis), group


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "flash", "blockwise"):
        raise ValueError("impl must be auto, flash or blockwise, got %r"
                         % impl)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis: str = "sp", causal: bool = False,
                   scale: Optional[float] = None,
                   impl: str = "auto") -> torch.Tensor:
    """Sequence-parallel attention over the ``axis`` ring. BHSD layout:
    this rank's block ``[B, H, S/n, D]`` of q, k, v in, its block of the
    output out; the queries attend over the whole sequence as the K/V
    blocks rotate past.

    ``impl``: "auto" runs each hop in the flash-attention kernels
    (:func:`ring_flash_attention`) when the tensors are on CUDA and
    :func:`..ops.attention.supports` holds for the block's shape (the
    reference: on the TPU backend); "flash" forces that path (on the CPU
    it runs the kernels' plain versions); "blockwise" keeps the
    online-softmax ring, each hop recomputed in the backward."""
    _check_impl(impl)
    b, h, s_local, d = q.shape
    if impl == "flash" or (
            impl == "auto" and q.device.type == "cuda"
            and attention.supports((b, h, s_local, d), q.dtype)):
        return ring_flash_attention(q, k, v, mesh, axis=axis, causal=causal,
                                    scale=scale)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    n, my, group = _axis(mesh, axis)
    pos = torch.arange(s_local, device=q.device)
    q_pos = my * s_local + pos
    acc, m, l = _softmax_state(q)
    kb, vb = k, v
    for r in range(n):
        if r:
            kb, vb = _shift_kv(kb, vb, group)
        # after r hops this rank holds the block born on (my - r) % n
        src = (my - r) % n
        acc, m, l = checkpoint(_block_update, q, kb, vb, acc, m, l, q_pos,
                               src * s_local + pos, scale, causal,
                               use_reentrant=False, preserve_rng_state=False)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _local_flash_blockwise(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, scale: float, causal: bool,
                           block_k: int = 512) -> torch.Tensor:
    """Blockwise online-softmax attention on one rank, dense inputs.

    Same memory discipline as the ring's per-hop update but over local KV
    blocks: peak score memory is O(S·block_k) instead of O(S²), and each
    block step is recomputed in the backward. Used by Ulysses after its
    all-to-all (the whole sequence is local there)."""
    s = q.shape[2]
    blk = min(block_k, s)
    while s % blk:
        blk -= 1  # largest divisor <= block_k; degenerates to 1 worst-case
    q_pos = torch.arange(s, device=q.device)
    acc, m, l = _softmax_state(q)
    for i in range(s // blk):
        acc, m, l = checkpoint(
            _block_update, q, k[:, :, i * blk:(i + 1) * blk],
            v[:, :, i * blk:(i + 1) * blk], acc, m, l, q_pos,
            q_pos[i * blk:(i + 1) * blk], scale, causal,
            use_reentrant=False, preserve_rng_state=False)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh: Mesh, axis: str = "sp", causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention where each hop's block runs in the flash-attention
    kernels (:func:`..ops.attention.flash_attention_lse`: B2a forward,
    B2b/B2c backward on CUDA tensors; their plain versions on the CPU).
    BHSD blocks in and out, as :func:`ring_attention`.

    Per hop the kernel returns (normalised block output, log-sum-exp);
    blocks merge exactly by LSE weighting, out = Σ_b exp(lse_b - LSE)·o_b,
    in fp32. Hop 0 is the local block, the only one that needs the
    kernel's causal mask; a rotated block born on an earlier ring
    position is wholly visible, a later one gets LSE ``NEG_INF`` (weight
    0; the kernel still runs, as in the reference). Differentiable end to
    end: the LSE's cotangent folds into the kernels' backward, and the
    ring's hop transposes itself."""
    n, my, group = _axis(mesh, axis)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out0, lse0 = attention.flash_attention_lse(q, k, v, scale=scale,
                                               causal=causal)
    m, num, den = lse0, out0.float(), torch.ones_like(lse0)
    kb, vb = k, v
    for r in range(1, n):
        kb, vb = _shift_kv(kb, vb, group)
        src = (my - r) % n  # the block born on ring position src
        o_r, lse_r = attention.flash_attention_lse(q, kb, vb, scale=scale,
                                                   causal=False)
        if causal and _invisible(src, my):
            lse_r = torch.full_like(lse_r, NEG_INF)
        m_new = torch.maximum(m, lse_r)
        c_old = torch.exp(m - m_new)
        c_new = torch.exp(lse_r - m_new)
        num = num * c_old[..., None] + o_r.float() * c_new[..., None]
        den = den * c_old + c_new
        m = m_new
    return (num / den[..., None]).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, axis: str = "sp", causal: bool = False,
                      scale: Optional[float] = None, impl: str = "auto",
                      block_k: int = 512) -> torch.Tensor:
    """All-to-all sequence parallelism (Ulysses). BHSD blocks in and out,
    as :func:`ring_attention`.

    Re-shards [B, H, S/n, D] -> [B, H/n, S, D] with one all-to-all (q, k
    and v together), runs local attention over the whole sequence for
    H/n heads, then swaps back. Requires H % n == 0, H this rank's
    heads (under tp, H / tp of the model's): it raises otherwise.

    ``impl``: "auto" runs the flash-attention kernels when the tensors
    are on CUDA and :func:`..ops.attention.supports` holds for
    ``[B, H/n, S, D]``, else the blockwise online-softmax loop
    (``block_k`` keys a step); "flash" forces the kernels (their plain
    versions on the CPU); "blockwise" the loop."""
    _check_impl(impl)
    b, h, s_local, d = q.shape
    if h % mesh.axis_size(axis):
        tp = mesh.axis_size("tp")
        raise ValueError(
            "heads %d must divide sp size %d: Ulysses splits this rank's "
            "heads over %r%s; take ring attention, or an sp that divides "
            "them" % (h, mesh.axis_size(axis), axis,
                      "" if tp == 1 else " (under tp %d a rank holds H / %d "
                      "of the model's H heads)" % (tp, tp)))
    n, _, group = _axis(mesh, axis)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    use_flash = impl == "flash" or (
        impl == "auto" and q.device.type == "cuda"
        and attention.supports((b, h // n, s_local * n, d), q.dtype))
    # [3, B, H, S/n, D] -> [3, B, H/n, S, D]
    qh, kh, vh = collectives.all_to_all(torch.stack((q, k, v)), group,
                                        split_axis=2, concat_axis=3)
    if use_flash:
        out = attention.flash_attention(qh, kh, vh, scale=scale,
                                        causal=causal)
    else:
        out = _local_flash_blockwise(qh, kh, vh, scale, causal,
                                     block_k=block_k)
    return collectives.all_to_all(out, group, split_axis=2, concat_axis=1)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense single-device attention over global arrays, fp32 softmax: the
    numeric oracle."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(q.shape[2], device=q.device)
        scores = torch.where(pos[:, None] >= pos[None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
