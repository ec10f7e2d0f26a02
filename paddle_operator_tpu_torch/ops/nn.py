"""Core layers as (init, apply) function pairs over dict trees of tensors:
the subset of ``paddle_operator_tpu/ops/nn.py`` that serving needs.

Layouts are the JAX package's, so a tree converted by :mod:`..bridge`
runs here unchanged: dense kernels are ``[in, out]``; the mha q/k/v
kernels are ``[dim, heads, head_dim]`` with bias ``[heads, head_dim]``
and the output kernel is ``[heads, head_dim, dim]``; an embedding is
``{"table": [vocab, dim]}``. Initializers draw from an explicit
``torch.Generator`` and create tensors on that generator's device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def xavier_uniform(generator: torch.Generator,
                   shape: Sequence[int]) -> torch.Tensor:
    """U(-l, l), l = sqrt(6 / (fan_in + fan_out)), of a 2-D [in, out]
    shape, in fp32."""
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    out = torch.empty(tuple(shape), device=generator.device)
    return out.uniform_(-limit, limit, generator=generator)


def normal_init(generator: torch.Generator, shape: Sequence[int],
                stddev: float = 0.02) -> torch.Tensor:
    out = torch.empty(tuple(shape), device=generator.device)
    return out.normal_(0.0, stddev, generator=generator)


def _zeros(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape), device=generator.device)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               use_bias: bool = True, init=xavier_uniform) -> Params:
    p = {"kernel": init(generator, (in_dim, out_dim))}
    if use_bias:
        p["bias"] = _zeros(generator, (out_dim,))
    return p


def dense(params: Params, x: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    y = torch.matmul(x.to(dtype), params["kernel"].to(dtype))
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def layernorm_init(dim: int, device: Optional[torch.device] = None
                   ) -> Params:
    return {"scale": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-6,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """LayerNorm over the last axis in fp32. The eps is the JAX
    package's 1e-6, not torch's default 1e-5."""
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def embedding_init(generator: torch.Generator, vocab: int, dim: int,
                   init=normal_init) -> Params:
    return {"table": init(generator, (vocab, dim))}


def embedding(params: Params, ids: torch.Tensor,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return params["table"][ids].to(dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def mha_init(generator: torch.Generator, dim: int, num_heads: int) -> Dict:
    """QKV kernels are [dim, heads, head_dim], O is [heads, head_dim, dim]
    (the JAX package's layout: the head axis is explicit)."""
    if dim % num_heads:
        raise ValueError("dim %d not divisible by heads %d" % (dim, num_heads))
    head_dim = dim // num_heads

    def proj() -> Params:
        return {"kernel": xavier_uniform(generator, (dim, dim)).reshape(
                    dim, num_heads, head_dim),
                "bias": _zeros(generator, (num_heads, head_dim))}

    q, k, v = proj(), proj(), proj()
    return {"q": q, "k": k, "v": v,
            "o": {"kernel": xavier_uniform(generator, (dim, dim)).reshape(
                      num_heads, head_dim, dim),
                  "bias": _zeros(generator, (dim,))}}


def rope(x: torch.Tensor, positions: Optional[torch.Tensor] = None,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the head dim, half-split (not
    interleaved). x: [B, S, H, D]; positions: [S], default arange."""
    _, s, _, d = x.shape
    half = d // 2
    if positions is None:
        positions = torch.arange(s, device=x.device)
    inv_freq = base ** (-torch.arange(0, half, dtype=torch.float32,
                                      device=x.device) / half)
    ang = positions.float()[:, None] * inv_freq[None, :]       # [S, half]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mha(params: Dict, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
        causal: bool = False, use_rope: bool = False,
        positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head self-attention, BSHD layout: the einsum path of the JAX
    ``mha``. Causally masked scores take ``finfo(dtype).min``."""
    def proj(p: Params) -> torch.Tensor:
        return (torch.einsum("bsd,dhk->bshk", x.to(dtype),
                             p["kernel"].to(dtype)) + p["bias"].to(dtype))

    q, k, v = proj(params["q"]), proj(params["k"]), proj(params["v"])
    if use_rope:
        q, k = rope(q, positions), rope(k, positions)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        s_len = scores.shape[-1]
        cmask = torch.tril(torch.ones((s_len, s_len), dtype=torch.bool,
                                      device=x.device))[None, None]
        scores = torch.where(cmask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return (torch.einsum("bqhd,hdo->bqo", ctx, params["o"]["kernel"].to(dtype))
            + params["o"]["bias"].to(dtype))


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (as ``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")
