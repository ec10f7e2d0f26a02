"""Seeded numpy inputs, and the bf16 comparison rule with the planted
faults it must reject, shared by the port's tests and ``chip_smoke.py``.

Inputs are made with numpy so that the JAX reference and the port see the
same numbers; each case is a dict of numpy arrays plus its shape fields.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops import attention

#: the additive part of the bf16 rule: covers fp32 summation-order
#: differences of results near 0, where one bf16 ulp is smaller than they
BF16_ATOL = 1e-5


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of ``x`` (fp32): ``2^(e - 8)`` for
    ``|x| = m 2^e`` with ``m`` in [0.5, 1), and 0 at 0."""
    x = x.float()
    _, e = torch.frexp(x)
    ulp = torch.pow(2.0, (e - 8).float())
    return torch.where(x == 0, torch.zeros_like(ulp), ulp)


def bf16_errors(got: torch.Tensor, want: torch.Tensor,
                atol: float = BF16_ATOL) -> dict:
    """``got`` against a bf16 ``want`` element by element: each may part
    from its ``want`` by one bf16 ulp of that value plus ``atol``, what
    two fp32 results that differ only in summation order may come to once
    each is rounded to bf16. ``worst`` is the largest error over its
    bound (at most 1 passes); ``outside`` counts elements over it."""
    err = torch.abs(got.float() - want.float())
    ratio = err / (bf16_ulp(want) + atol)
    return {"max_abs_err": err.max().item(), "worst": ratio.max().item(),
            "outside": int(torch.count_nonzero(ratio > 1).item())}


def causal_attention_autograd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor,
                              scale: float, edge: int = 0
                              ) -> Dict[str, torch.Tensor]:
    """Causal attention materialised in fp32, differentiated by autograd
    (another summation order than the kernels' and the plain versions').
    ``edge`` is how many keys past the diagonal the mask reaches: 1 plants
    an off-by-one fault. O, dQ, dK and dV for the cotangent ``dout``, in
    q's type."""
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    s = torch.matmul(leaves[0] * scale, leaves[1].transpose(-1, -2))
    n = s.shape[-1]
    keep = torch.tril(torch.ones((n, n), dtype=torch.bool, device=s.device),
                      diagonal=edge)
    p = torch.softmax(torch.where(keep, s, -1e30), dim=-1)
    out = torch.matmul(p, leaves[2])
    grads = torch.autograd.grad(out, leaves, dout.float())
    return {name: x.detach().to(q.dtype)
            for name, x in zip(("o", "dq", "dk", "dv"), (out, *grads))}


def bf16_parts(x: torch.Tensor, split: bool = True) -> list:
    """fp32 ``x`` as the bf16 tensor-core operands that carry it: ``[hi,
    lo]`` with ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` (``x - hi`` is
    exact in fp32), or ``[hi]`` alone when ``split`` is False; each as
    fp32, so that a product of them sums in fp32."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()] if split else [hi]


def mma_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool, split: bool = True,
                  block_k: int = 64):
    """A plain model of the rounding of the bf16 forward kernel
    (``flash_fwd_mma_kernel``): ``scale * (q k^T)`` summed in fp32 from
    the bf16 operands, an online softmax over ``block_k``-key tiles, and
    ``O += P v`` with P (fp32) carried as :func:`bf16_parts`. Returns
    ``(O in q's type, LSE fp32)`` as ``_plain_flash_fwd`` does."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = attention._causal_mask(s)
    rows = s.shape[:-1] + (1,)
    m = torch.full(rows, attention.NEG_INF, device=s.device)
    l = torch.zeros(rows, device=s.device)
    acc = torch.zeros(q.shape, device=s.device)
    for k0 in range(0, s.shape[-1], block_k):
        tile = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(tile - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr
        for part in bf16_parts(p, split):
            acc = acc + torch.matmul(part, v[..., k0:k0 + block_k, :].float())
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def mma_flash_dkv(q, k, v, dout, lse, delta, scale: float, causal: bool,
                  split: bool = True):
    """A plain model of the rounding of the bf16 dK/dV kernel
    (``flash_dkv_mma_kernel``): P and dS in fp32 from bf16 operands, as
    ``_plain_flash_dkv`` has them, then ``dV = P^T dO`` and ``dK = scale *
    dS^T q`` with P and dS carried as :func:`bf16_parts`. Returns ``(dK,
    dV)`` in k's and v's types."""
    p = attention._plain_probs(q, k, lse, scale, causal)
    ds = attention._plain_ds(p, v, dout, delta)
    dv = sum(torch.matmul(part.transpose(-1, -2), dout.float())
             for part in bf16_parts(p, split))
    dk = sum(torch.matmul(part.transpose(-1, -2), q.float())
             for part in bf16_parts(ds, split)) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def mma_flash_dq(q, k, v, dout, lse, delta, scale: float, causal: bool,
                 split: bool = True):
    """A plain model of the rounding of the bf16 dQ kernel
    (``flash_dq_mma_kernel``): P and dS in fp32 from bf16 operands, as
    ``_plain_flash_dq`` has them, then ``dQ = scale * dS k`` with dS
    carried as :func:`bf16_parts`. Returns dQ in q's type."""
    p = attention._plain_probs(q, k, lse, scale, causal)
    ds = attention._plain_ds(p, v, dout, delta)
    dq = sum(torch.matmul(part, k.float())
             for part in bf16_parts(ds, split)) * scale
    return dq.to(q.dtype)


def misscaled_tile(x: torch.Tensor, rows: int = 64) -> torch.Tensor:
    """A planted fault: ``x`` ``[B, H, S, D]`` with one tile (first batch
    and head, ``rows`` rows from S/2) scaled by 1 + 2^-6."""
    y = x.clone()
    start = x.shape[2] // 2
    y[0, 0, start:start + rows] *= 1 + 2.0 ** -6
    return y

#: the paged-decode cases: the ragged, non-contiguous case of the JAX
#: package's serving tests; a bs=16, head_dim=128 case; lengths the engine
#: never gives (0, where every slot ties at NEG_INF and the result is the
#: mean of V over the table, and one past T * bs, which counts as T * bs);
#: and the full-width decode shape of GPT-2 small under the engine (B=8,
#: H=12, D=64, bs=16, T=64 pages of a 1024-token max_seq)
PAGED_CASES = ("ragged", "bs16_d128", "edge_lens", "full_width")


def paged_decode_case(name: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """q [B,H,D], k_pages/v_pages [P,bs,H,D] fp32, tables [B,T] int32,
    lens [B] int32."""
    rng = np.random.default_rng(seed)
    if name == "ragged":
        b, h, d, bs, pages = 3, 2, 64, 8, 16
        tables = np.asarray([[1, 5, 9, 13], [2, 6, 10, 14], [3, 7, 11, 0]])
        lens = np.asarray([5, 16, 23])
    elif name == "bs16_d128":
        b, h, d, bs, pages, t = 4, 3, 128, 16, 24, 5
        tables = rng.permutation(pages)[:b * t].reshape(b, t)
        lens = np.asarray([1, 17, 40, t * bs])
    elif name == "edge_lens":
        b, h, d, bs, pages, t = 4, 2, 64, 8, 16, 3
        tables = rng.permutation(pages)[:b * t].reshape(b, t)
        lens = np.asarray([0, t * bs + 16, 7, 0])
    elif name == "full_width":
        b, h, d, bs, t = 8, 12, 64, 16, 64
        pages = b * t + 1
        tables = rng.permutation(pages)[:b * t].reshape(b, t)
        lens = rng.integers(1, t * bs + 1, size=b)
        lens[0] = t * bs                       # one sequence fills its table
    else:
        raise ValueError("unknown paged-decode case %r" % name)
    return {
        "q": rng.standard_normal((b, h, d), dtype=np.float32),
        "k_pages": rng.standard_normal((pages, bs, h, d), dtype=np.float32),
        "v_pages": rng.standard_normal((pages, bs, h, d), dtype=np.float32),
        "tables": np.asarray(tables, dtype=np.int32),
        "lens": np.asarray(lens, dtype=np.int32),
    }
