"""Core layers as (init, apply) function pairs over dict trees of tensors:
the subset of ``paddle_operator_tpu/ops/nn.py`` that serving, ResNet
training and GPT training need.

Layouts are the JAX package's, so a tree converted by :mod:`..bridge`
runs here unchanged: dense kernels are ``[in, out]``; conv kernels are
HWIO on NHWC activations; BatchNorm keeps ``{scale, bias, mean, var}``
in the tree; the mha q/k/v kernels are ``[dim, heads, head_dim]`` with
bias ``[heads, head_dim]`` and the output kernel is
``[heads, head_dim, dim]``; an embedding is ``{"table": [vocab, dim]}``.
Initializers draw from an explicit ``torch.Generator`` and create tensors
on that generator's device.

NHWC activations are contiguous; their ``[B, C, H, W]`` view is
``channels_last`` in memory, which is what cuDNN's NHWC convolutions
take, so :func:`conv2d` and :func:`max_pool` copy nothing to change
layout.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import collectives

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


def kaiming_normal(generator: torch.Generator,
                   shape: Sequence[int]) -> torch.Tensor:
    """N(0, 2 / fan_in) in fp32; fan_in of an HWIO kernel is H*W*I, of a
    2-D ``[in, out]`` kernel ``in``."""
    fan_in = shape[0] if len(shape) == 2 else math.prod(shape[:-1])
    out = torch.empty(tuple(shape), device=generator.device)
    return out.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


# ---------------------------------------------------------------------------
# conv2d (NHWC / HWIO), pooling
# ---------------------------------------------------------------------------

def conv_init(generator: torch.Generator, kh: int, kw: int, in_ch: int,
              out_ch: int, init=kaiming_normal) -> Params:
    return {"kernel": init(generator, (kh, kw, in_ch, out_ch))}


def same_padding(size: int, window: int, stride: int) -> Tuple[int, int]:
    """(before, after) of XLA's SAME padding along one axis: the output
    has ``ceil(size / stride)`` positions and any odd pad goes after
    (7x7/2 at 224: (2, 3); 3x3/2 on an even size: (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same_nhwc(x: torch.Tensor, window: int, stride: int,
                   value: float = 0.0) -> Tuple[torch.Tensor, int, int]:
    """Pad an NHWC tensor for a SAME window. Symmetric pads are returned
    as (ph, pw) for the op's own padding argument; asymmetric ones are
    applied here (the op then pads nothing)."""
    ph = same_padding(x.shape[1], window, stride)
    pw = same_padding(x.shape[2], window, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, ph[0], pw[0]
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=value), 0, 0


class _OihwKernel(torch.autograd.Function):
    """An HWIO kernel as the OIHW ``channels_last`` tensor cuDNN's NHWC
    convolutions read (memory order O, H, W, I), cast to the compute type
    in the same copy. The backward writes the grad back as a contiguous
    HWIO tensor of the kernel's type, also in one copy: a plain
    permute-and-cast would hand the optimizer a strided view."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ctx.w_dtype = w.dtype
        oihw = w.permute(3, 2, 0, 1)
        out = torch.empty(oihw.shape, dtype=dtype, device=w.device,
                          memory_format=torch.channels_last)
        return out.copy_(oihw)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        hwio = grad.permute(2, 3, 1, 0)
        out = torch.empty(hwio.shape, dtype=ctx.w_dtype, device=grad.device)
        return out.copy_(hwio), None


def conv2d(params: Params, x: torch.Tensor, stride: int = 1,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """SAME convolution of NHWC ``x`` with an HWIO kernel, in ``dtype``;
    returns NHWC. The kernel's grad comes back contiguous HWIO."""
    w = params["kernel"]
    x, ph, pw = _pad_same_nhwc(x.to(dtype), w.shape[0], stride)
    w = _OihwKernel.apply(w, dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=(ph, pw))
    return y.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """SAME max pool over NHWC ``x``; the padding is -inf, so a padded
    position never wins."""
    x, ph, pw = _pad_same_nhwc(x, window, stride, value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding=(ph, pw))
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W of NHWC ``x``, in fp32."""
    return x.float().mean(dim=(1, 2))


# ---------------------------------------------------------------------------
# batchnorm
# ---------------------------------------------------------------------------

def batchnorm_init(ch: int, device: Optional[torch.device] = None
                   ) -> Params:
    return {"scale": torch.ones((ch,), device=device),
            "bias": torch.zeros((ch,), device=device),
            # running stats live beside params, updated out of band
            "mean": torch.zeros((ch,), device=device),
            "var": torch.ones((ch,), device=device)}


def batchnorm(params: Params, x: torch.Tensor, train: bool,
              momentum: float = 0.9, eps: float = 1e-5,
              dtype: torch.dtype = torch.bfloat16
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """BatchNorm over every axis but the last (channels), the JAX
    package's formula: in train mode the biased variance is taken in one
    pass around the running mean ``c`` (detached), clamped at 0, and the
    new running stats (momentum on the OLD value) are returned, detached,
    never written here. Returns ``(y, new_stats)``; ``new_stats`` is None
    in eval mode. ``nn.BatchNorm2d`` differs (unbiased running variance,
    buffers updated inside forward), so the formula is written out.

    Sync BatchNorm, as the reference's: inside a dp train step
    (:func:`..parallel.collectives.sync_batch`) the per-channel means of
    ``d`` and ``d**2`` are averaged over the ranks in one collective,
    differentiably, so the statistics, the running stats and the
    gradients are those of the global batch (the ranks' shards are of
    one size). Without a group the formula and its rounding are the
    single-device ones."""
    xf = x.float()
    if train:
        axes = tuple(range(x.ndim - 1))
        c = params["mean"].float().detach()
        d = xf - c
        dmean = d.mean(dim=axes)
        sq_mean = torch.square(d).mean(dim=axes)
        group = collectives.batch_group()
        if group is not None:
            dmean, sq_mean = collectives.mean_with_grad(
                torch.stack([dmean, sq_mean]), group).unbind(0)
        var = torch.clamp(sq_mean - torch.square(dmean), min=0.0)
        mean = dmean + c
        with torch.no_grad():
            new_stats = {
                "mean": momentum * params["mean"] + (1 - momentum) * mean,
                "var": momentum * params["var"] + (1 - momentum) * var,
            }
    else:
        mean, var = params["mean"], params["var"]
        new_stats = None
    inv = torch.rsqrt(var + eps) * params["scale"]
    y = (xf - mean) * inv + params["bias"]
    return y.to(dtype), new_stats


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch, in fp32; labels are int ids."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


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


def mha(params: Dict, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
        dtype: torch.dtype = torch.bfloat16,
        impl: Union[str, Callable] = "einsum", causal: bool = False,
        use_rope: bool = False,
        positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head self-attention, BSHD layout, with the reference's
    dispatch.

    impl: "einsum" (the default), "flash" (:func:`.attention.flash_attention`:
    kernels B2 on CUDA tensors, their plain versions on the CPU), "auto"
    (flash for CUDA tensors when the shape tiles, the counterpart of the
    reference's flash-on-TPU), or a callable ``(q, k, v) -> ctx`` in BHSD
    that owns masking. Flash is taken only without a ``mask`` and when
    :func:`.attention.supports` holds. On the einsum path a boolean
    ``mask`` (broadcast to ``[B, H, Q, K]``) and the causal mask set
    masked scores to ``finfo(dtype).min``."""
    def proj(p: Params) -> torch.Tensor:
        return (torch.einsum("bsd,dhk->bshk", x.to(dtype),
                             p["kernel"].to(dtype)) + p["bias"].to(dtype))

    q, k, v = proj(params["q"]), proj(params["k"]), proj(params["v"])
    if use_rope:
        q, k = rope(q, positions), rope(k, positions)

    if callable(impl):
        if mask is not None or causal:
            raise ValueError(
                "callable attention impls own their masking/causality: pass "
                "causal inside the callable")
        ctx = impl(q.transpose(1, 2), k.transpose(1, 2),
                   v.transpose(1, 2)).transpose(1, 2)
        return _out_proj(params, ctx, dtype)

    use_flash = False
    if impl in ("flash", "auto") and mask is None:
        from . import attention

        b, s, h, d = q.shape
        use_flash = attention.supports((b, h, s, d), dtype)
        if impl == "auto":
            use_flash = use_flash and x.device.type == "cuda"

    if use_flash:
        ctx = attention.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal).transpose(1, 2)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(
            q.shape[-1])
        if causal:
            s_len = scores.shape[-1]
            cmask = torch.tril(torch.ones((s_len, s_len), dtype=torch.bool,
                                          device=x.device))[None, None]
            mask = cmask if mask is None else torch.logical_and(mask, cmask)
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return _out_proj(params, ctx, dtype)


def _out_proj(params: Dict, ctx: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """MHA output projection: [B, S, H, D] context -> [B, S, dim]."""
    return (torch.einsum("bqhd,hdo->bqo", ctx, params["o"]["kernel"].to(dtype))
            + params["o"]["bias"].to(dtype))


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (as ``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# LM-head cross-entropy
# ---------------------------------------------------------------------------

def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result from operands of one type. On CUDA a
    low-precision product accumulates and returns in fp32 in one cuBLAS
    call (``out_dtype``); on the CPU the operands, already rounded to
    their type, are upcast first, which is the same math up to summation
    order."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of low-precision operands with fp32 logits, the
    counterpart of ``jnp.matmul(..., preferred_element_type=float32)``.
    The backward rounds the fp32 cotangent to the operands' type and takes
    two such products, returning grads in the operands' types."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (_mm_f32(g, b.t()).to(a.dtype),
                _mm_f32(a.t(), g).to(b.dtype))


def chunked_lm_xent(head_params: Params, hidden: torch.Tensor,
                    labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, chunk: int = 1024,
                    dtype: torch.dtype = torch.bfloat16,
                    denom: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy through a big-vocab LM head without materialising the
    ``[tokens, vocab]`` logits (the reference's ``chunked_lm_xent``).

    Tokens are padded to whole chunks; each chunk runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so
    its forward keeps only per-token scalars and the backward recomputes
    its fp32 logits from ``(hidden chunk, kernel)``; a Python loop over
    the chunks is the reference's ``scan``. Logits are fp32 from
    ``dtype`` operands. Returns ``(mean loss, accuracy)`` fp32 over the
    masked positions (``mask`` weighs label positions); ``denom``, if
    given, replaces the mask's sum as the divisor (a sequence block's part
    of the whole sequence's mean)."""
    d = hidden.shape[-1]
    flat_h = hidden.reshape(-1, d)
    flat_l = labels.reshape(-1).long()
    n = flat_h.shape[0]
    flat_m = (torch.ones((n,), dtype=torch.float32, device=hidden.device)
              if mask is None else mask.reshape(-1).float())
    chunk = max(1, min(chunk, n))
    pad = (-n) % chunk
    if pad:
        flat_h = torch.cat([flat_h, flat_h.new_zeros((pad, d))])
        flat_l = torch.cat([flat_l, flat_l.new_zeros((pad,))])
        flat_m = torch.cat([flat_m, flat_m.new_zeros((pad,))])
    bias = head_params.get("bias")

    def one_chunk(h, l, m, kernel, bias):
        h, kernel = h.to(dtype), kernel.to(dtype)
        logits = (torch.matmul(h, kernel) if dtype == torch.float32
                  else _MatmulF32.apply(h, kernel))
        if bias is not None:
            logits = logits + bias.float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, l[:, None])[:, 0]
        correct = (logits.argmax(dim=-1) == l).float()
        return torch.sum((lse - picked) * m), torch.sum(correct * m)

    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    acc_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, flat_h.shape[0], chunk):
        sl = slice(i, i + chunk)
        ls, acc = checkpoint(one_chunk, flat_h[sl], flat_l[sl], flat_m[sl],
                             head_params["kernel"], bias,
                             use_reentrant=False, preserve_rng_state=False)
        loss_sum = loss_sum + ls
        acc_sum = acc_sum + acc
    if denom is None:
        denom = torch.clamp(torch.sum(flat_m), min=1.0)
    return loss_sum / denom, acc_sum / denom
