"""Core layers as (init, apply) function pairs over dict trees of tensors:
the subset of ``paddle_operator_tpu/ops/nn.py`` that serving, ResNet,
GPT, BERT and CTR training need.

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


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE in fp32, the reference's stable formula:
    ``max(x, 0) - x y + log1p(exp(-|x|))``. At ``x = 0`` the gradient is
    JAX's: ``torch.maximum`` splits it as ``jnp.maximum`` does, and ``|x|``
    is written so that its slope there is 1, as ``jnp.abs``'s is
    (``torch.abs`` gives 0)."""
    x, y = logits.float(), labels.float()
    abs_x = torch.where(x >= 0, x, -x)
    return (torch.maximum(x, torch.zeros_like(x)) - x * y
            + torch.log1p(torch.exp(-abs_x))).mean()


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


#: the leaves under an mha's and an MLP's paths that one tp group splits
#: together: the attention's heads, the MLP's hidden units
MHA_TILES = ("q/kernel", "q/bias", "k/kernel", "k/bias", "v/kernel",
             "v/bias", "o/kernel")
MLP_TILES = ("fc1/kernel", "fc1/bias", "fc2/kernel")


def split_group(split: Optional[collectives.Split], prefix: str,
                names: Sequence[str]) -> collectives.Group:
    """The group the leaves ``prefix + name`` are split over
    (:attr:`..parallel.collectives.Split.tiles`), ``None`` when every one
    is whole; raises if only some are split (a layer cannot compute on
    such a mix)."""
    tiles = [split.tile(prefix + n) if split is not None else None
             for n in names]
    if all(t is None for t in tiles):
        return None
    if any(t is None for t in tiles):
        raise NotImplementedError(
            "the leaves %s under %r are split only in part (%s); a layer "
            "computes on all of them split or none" % (
                list(names), prefix, [t is not None for t in tiles]))
    return tiles[0].group


def column_dense(params: Params, x: torch.Tensor, dtype: torch.dtype,
                 group: collectives.Group) -> torch.Tensor:
    """A column-parallel dense layer (Megatron's): ``params`` hold this
    rank's columns of the kernel and of the bias, and the replicated
    input goes through :func:`..parallel.collectives.sum_backward`, so
    its gradient sums the ranks' parts. Without a group, :func:`dense`."""
    return dense(params, collectives.sum_backward(
        x, group, collectives.tp_traffic), dtype)


def row_parallel(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor], dtype: torch.dtype,
                 group: collectives.Group) -> torch.Tensor:
    """A row-parallel product: ``x`` ``[..., K/n]`` times this rank's
    rows ``kernel`` ``[K/n, out]``, in fp32 from ``dtype`` operands, summed
    over ``group`` in fp32, rounded once to ``dtype``, and then the
    replicated ``bias`` added once. One process's cuBLAS product
    accumulates in fp32 and rounds once; the fp32 sum keeps the split
    product closest to it. Without a group, the plain product."""
    if collectives.size(group) == 1:
        y = torch.matmul(x.to(dtype), kernel.to(dtype))
    else:
        lead = x.shape[:-1]
        a, b = x.reshape(-1, x.shape[-1]).to(dtype), kernel.to(dtype)
        y = (torch.matmul(a, b) if dtype == torch.float32
             else _MatmulF32.apply(a, b))
        y = collectives.sum_forward(y, group, collectives.tp_traffic)
        y = y.reshape(*lead, kernel.shape[-1]).to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def row_dense(params: Params, x: torch.Tensor, dtype: torch.dtype,
              group: collectives.Group) -> torch.Tensor:
    """A row-parallel dense layer: this rank's rows of the kernel, its
    slice of the input, the bias (replicated) after the sum
    (:func:`row_parallel`)."""
    return row_parallel(x, params["kernel"], params.get("bias"), dtype,
                        group)


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
              dtype: torch.dtype = torch.bfloat16,
              tile: Optional[collectives.Tile] = None) -> torch.Tensor:
    """``table[ids]`` in ``dtype``; with ``tile``, the table is this rank's
    rows of a vocabulary split over ``tile.group``
    (:func:`..parallel.collectives.vocab_lookup`)."""
    if tile is not None:
        return collectives.vocab_lookup(params["table"], ids, tile, dtype)
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
        positions: Optional[torch.Tensor] = None,
        tp: collectives.Group = None) -> torch.Tensor:
    """Multi-head self-attention, BSHD layout, with the reference's
    dispatch.

    ``tp``: the heads are split over this group (Megatron's layout):
    ``params`` hold this rank's heads, the q/k/v kernels ``[dim, H/n,
    head_dim]`` and biases ``[H/n, head_dim]`` (column-parallel, the input
    through :func:`..parallel.collectives.sum_backward`), attention runs
    on ``[B, H/n, S, head_dim]``, and the output projection is
    row-parallel over its ``[H/n, head_dim, dim]`` kernel, the bias added
    after the sum (:func:`row_parallel`).

    impl: "einsum" (the default), "flash" (:func:`.attention.flash_attention`:
    kernels B2 on CUDA tensors, their plain versions on the CPU), "auto"
    (flash for CUDA tensors when the shape tiles, the counterpart of the
    reference's flash-on-TPU), or a callable ``(q, k, v) -> ctx`` in BHSD
    that owns masking. Flash is taken only without a ``mask`` and when
    :func:`.attention.supports` holds. On the einsum path a boolean
    ``mask`` (broadcast to ``[B, H, Q, K]``) and the causal mask set
    masked scores to ``finfo(dtype).min``."""
    x = collectives.sum_backward(x, tp, collectives.tp_traffic)

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
        return _out_proj(params, ctx, dtype, tp)

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
    return _out_proj(params, ctx, dtype, tp)


def _out_proj(params: Dict, ctx: torch.Tensor, dtype: torch.dtype,
              tp: collectives.Group = None) -> torch.Tensor:
    """MHA output projection: [B, S, H, D] context -> [B, S, dim];
    row-parallel over ``tp`` (this rank's heads)."""
    if collectives.size(tp) > 1:
        b, s, h, d = ctx.shape
        kernel = params["o"]["kernel"]
        return row_parallel(ctx.reshape(b, s, h * d),
                            kernel.reshape(h * d, kernel.shape[-1]),
                            params["o"]["bias"], dtype, tp)
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
                    denom: Optional[torch.Tensor] = None,
                    tile: Optional[collectives.Tile] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy through a big-vocab LM head without materialising the
    ``[tokens, vocab]`` logits (the reference's ``chunked_lm_xent``).

    ``tile``: the head kernel is this rank's columns ``[D, V/n]`` of a
    vocabulary split over ``tile.group`` (and a bias its slice): each
    chunk's per-token log-sum-exp, picked logit and argmax come from
    :func:`..parallel.collectives.vocab_xent_pieces`, and the hidden
    states' gradient is summed over the group.

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
    if tile is not None:
        hidden = collectives.sum_backward(hidden, tile.group,
                                          collectives.tp_traffic)
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
        lse, picked, argmax = xent_pieces(logits, l, tile)
        correct = (argmax == l).float()
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


def xent_pieces(logits: torch.Tensor, labels: torch.Tensor,
                tile: Optional[collectives.Tile] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(lse, picked, argmax)`` of ``[N, V]`` fp32 logits and ``[N]``
    labels; with ``tile``, of logits split by columns over ``tile.group``
    (:func:`..parallel.collectives.vocab_xent_pieces`)."""
    if tile is not None:
        return collectives.vocab_xent_pieces(logits, labels, tile)
    return (torch.logsumexp(logits, dim=-1),
            logits.gather(-1, labels[:, None])[:, 0],
            logits.argmax(dim=-1))
