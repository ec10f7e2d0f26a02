"""BERT encoder with a masked-LM head, the counterpart of
``paddle_operator_tpu/models/bert.py``: forward, training loss and
synthetic batches.

Post-LN encoder layers on the port's ``nn`` layers. The parameter tree has
the JAX package's keys and layouts (``embed.{tok, pos, type, ln}``,
``layers[i].{attn, ln1, ln2, mlp.{fc1, fc2} | moe}``, ``pooler``,
``mlm.{transform, ln, decoder}``), so a tree initialised by the JAX
package and converted by :mod:`..bridge` runs here unchanged. Compute is
in ``dtype`` (bf16 by default) on fp32 parameters; the MLM decoder runs in
fp32, as the reference's.

Attention keeps the reference's dispatch: ``encode`` turns an
``attention_mask`` into a mask for ``nn.mha``, and a mask takes the einsum
path, so BERT as :func:`synthetic_batch` feeds it (an all-ones mask) runs
no attention kernel. With ``moe_experts > 0`` every ``moe_every``-th FFN
is a switch-MoE block (:mod:`..ops.moe`), routed over the global batch
across worker processes (:func:`..parallel.collectives.moe_split`, read
once a forward). ``remat`` recomputes each layer in the backward
(non-reentrant ``torch.utils.checkpoint``).

Under a mesh the loss's denominator is the global batch's: each rank
divides its masked sum by the mean of the token group's mask sums, so
that the ranks' losses averaged over the batch axis are the reference's
loss on the global batch whatever the mask puts on each rank. Under a
sequence split (the train step's ``seq_axis``) :func:`loss_fn` takes
this rank's block of every sequence and runs attention over the sp axis
(ring or Ulysses), as GPT's does.

Under tensor parallelism (``bert_rules`` on a ``tp`` axis:
:func:`..parallel.collectives.model_tiles`) the encoder layers run on
this rank's heads and MLP columns as GPT's blocks do
(:func:`..ops.nn.split_group`), the token embedding is a vocabulary-parallel
lookup, and the MLM decoder ``[D, V/n]`` with its bias ``[V/n]`` gives
this rank's columns of the logits, whose loss takes the
vocabulary-parallel pieces. A vocabulary that does not divide by tp
(BERT-base's 30522 at tp 4) leaves those three leaves whole, and the
loss takes the plain path.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import nn
from ..ops.moe import moe_apply, moe_init
from ..parallel import collectives

F32 = torch.float32

BASE_CONFIG = dict(
    vocab_size=30522, hidden=768, layers=12, heads=12, mlp_dim=3072,
    max_seq=512, type_vocab=2, moe_experts=0, moe_every=2,
)

TINY_CONFIG = dict(
    vocab_size=1024, hidden=128, layers=2, heads=4, mlp_dim=256,
    max_seq=128, type_vocab=2, moe_experts=0, moe_every=2,
)

TINY_MOE_CONFIG = dict(TINY_CONFIG, moe_experts=4, moe_every=1)


def init(generator: torch.Generator, config: Optional[dict] = None) -> Dict:
    """Random parameters drawn from ``generator``, on its device. The
    numbers differ from the JAX package's for the same seed; tests that
    compare the two start from a JAX-initialised tree."""
    cfg = dict(BASE_CONFIG, **(config or {}))
    h, mlp = cfg["hidden"], cfg["mlp_dim"]
    dev = generator.device
    params: Dict = {
        "embed": {
            "tok": nn.embedding_init(generator, cfg["vocab_size"], h),
            "pos": nn.embedding_init(generator, cfg["max_seq"], h),
            "type": nn.embedding_init(generator, cfg["type_vocab"], h),
            "ln": nn.layernorm_init(h, dev),
        },
        "layers": [],
        "pooler": nn.dense_init(generator, h, h),
        "mlm": {
            "transform": nn.dense_init(generator, h, h),
            "ln": nn.layernorm_init(h, dev),
            "decoder": nn.dense_init(generator, h, cfg["vocab_size"]),
        },
    }
    for li in range(cfg["layers"]):
        layer = {
            "attn": nn.mha_init(generator, h, cfg["heads"]),
            "ln1": nn.layernorm_init(h, dev),
            "ln2": nn.layernorm_init(h, dev),
        }
        if cfg["moe_experts"] and li % cfg["moe_every"] == 0:
            layer["moe"] = moe_init(generator, h, mlp, cfg["moe_experts"])
        else:
            layer["mlp"] = {"fc1": nn.dense_init(generator, h, mlp),
                            "fc2": nn.dense_init(generator, mlp, h)}
        params["layers"].append(layer)
    return params


def _encoder_layer(layer: Dict, x: torch.Tensor,
                   mask: Optional[torch.Tensor], dtype: torch.dtype,
                   attn_impl: Any = "auto",
                   split: Optional[collectives.Split] = None,
                   prefix: str = ""
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Post-LN encoder layer: ln1(x + attn(x)), then ln2(x + ffn(x)).
    Returns ``(x, aux)``, aux the MoE load-balancing loss (0 for a dense
    FFN). ``prefix``: the layer's path (``layers/3/``), for its tiles."""
    y = nn.mha(layer["attn"], x, mask, dtype=dtype, impl=attn_impl,
               tp=nn.split_group(split, prefix + "attn/", nn.MHA_TILES))
    x = nn.layernorm(layer["ln1"], x + y, dtype=dtype)
    aux = torch.zeros((), dtype=F32, device=x.device)
    if "moe" in layer:
        y, moe_aux = moe_apply(layer["moe"], x, dtype=dtype, split=split)
        aux = aux + moe_aux["moe_aux_loss"]
    else:
        tp = nn.split_group(split, prefix + "mlp/", nn.MLP_TILES)
        y = nn.column_dense(layer["mlp"]["fc1"], x, dtype, tp)
        y = nn.gelu(y)
        y = nn.row_dense(layer["mlp"]["fc2"], y, dtype, tp)
    return nn.layernorm(layer["ln2"], x + y, dtype=dtype), aux


def encode(params: Dict, input_ids: torch.Tensor,
           type_ids: Optional[torch.Tensor] = None,
           attention_mask: Optional[torch.Tensor] = None,
           dtype: torch.dtype = torch.bfloat16, remat: bool = False,
           attn_impl: Any = "auto",
           positions: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_ids ``[B, S]`` -> (hidden states ``[B, S, H]`` in ``dtype``,
    the layers' MoE aux loss summed in fp32). ``positions`` ``[S]``: the
    tokens' positions (default ``arange(S)``; a block of a sequence split
    over ranks passes its global positions)."""
    _, s = input_ids.shape
    split = collectives.moe_split()
    x = nn.embedding(params["embed"]["tok"], input_ids, dtype,
                     split.tile("embed/tok/table"))
    if positions is None:
        positions = torch.arange(s, device=input_ids.device)
    x = x + nn.embedding(params["embed"]["pos"], positions[None, :], dtype)
    if type_ids is None:
        type_ids = torch.zeros_like(input_ids)
    x = x + nn.embedding(params["embed"]["type"], type_ids, dtype)
    x = nn.layernorm(params["embed"]["ln"], x, dtype=dtype)

    mask = None
    if attention_mask is not None:
        mask = attention_mask[:, None, None, :].bool()

    aux = torch.zeros((), dtype=F32, device=input_ids.device)
    for li, layer in enumerate(params["layers"]):
        prefix = "layers/%d/" % li
        if remat:
            x, layer_aux = checkpoint(_encoder_layer, layer, x, mask, dtype,
                                      attn_impl, split, prefix,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            x, layer_aux = _encoder_layer(layer, x, mask, dtype, attn_impl,
                                          split, prefix)
        aux = aux + layer_aux
    return x, aux


def mlm_logits(params: Dict, hidden: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The MLM head: transform, gelu, LayerNorm, then the decoder in fp32
    -> ``[B, S, V]`` fp32 logits; with the decoder split over tp
    (:func:`..parallel.collectives.model_tiles`), this rank's columns
    ``[B, S, V/n]``."""
    y = nn.dense(params["mlm"]["transform"], hidden, dtype)
    y = nn.gelu(y)
    y = nn.layernorm(params["mlm"]["ln"], y, dtype=dtype)
    tp = nn.split_group(collectives.moe_split(), "mlm/decoder/",
                        ("kernel", "bias"))
    return nn.column_dense(params["mlm"]["decoder"], y, F32, tp)


def loss_fn(params: Dict, batch: Dict, train: bool = True,
            dtype: torch.dtype = torch.bfloat16, remat: bool = False,
            attn_impl: Any = "auto", moe_aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict]:
    """Masked-LM loss. batch = {input_ids, labels, [type_ids,
    attention_mask, loss_mask]}; labels ``[B, S]``, positions with
    ``loss_mask`` 0 ignored. Returns ``(loss, {"accuracy", "moe_aux"})``;
    the loss includes ``moe_aux_weight * moe_aux``.

    Under a sequence split of n blocks (the train step's ``seq_axis``:
    ``collectives.seq_block()``) the batch's token axis is whole; this
    rank runs block i of every leaf at positions ``i S/n +
    arange(S/n)``, with ``attn_impl`` a ring or Ulysses attention over
    the same axis, and its loss and accuracy are the block's sums over
    the global masked count, so that the blocks' losses add up to the
    replica's. The ring takes no key mask: an all-ones
    ``attention_mask`` (what :func:`synthetic_batch` gives) is dropped,
    one with zeros raises."""
    ids, type_ids, amask = (batch["input_ids"], batch.get("type_ids"),
                            batch.get("attention_mask"))
    labels, mask = batch["labels"].long(), batch.get("loss_mask")
    index, count = collectives.seq_block()
    positions = None
    if count > 1:
        s = ids.shape[1]
        if s % count:
            raise ValueError("seq len %d must divide ring size %d"
                             % (s, count))
        if not callable(attn_impl):
            raise ValueError(
                "under a sequence split the attention runs over the sp "
                "axis: pass ring or Ulysses attention as attn_impl")
        if amask is not None:
            if not bool(torch.all(amask != 0)):
                raise NotImplementedError(
                    "an attention_mask with zeros under a sequence split: "
                    "ring and Ulysses attention take no key mask")
            amask = None  # all ones: the attention sees every key
        s_local = s // count
        start = index * s_local
        positions = start + torch.arange(s_local, device=ids.device)
        ids, labels = ids[:, start:start + s_local], \
            labels[:, start:start + s_local]
        if type_ids is not None:
            type_ids = type_ids[:, start:start + s_local]
        if mask is not None:
            mask = mask[:, start:start + s_local]
    hidden, moe_aux = encode(params, ids, type_ids, amask, dtype=dtype,
                             remat=remat, attn_impl=attn_impl,
                             positions=positions)
    logits = mlm_logits(params, hidden, dtype)
    tile = collectives.moe_split().tile("mlm/decoder/kernel")
    if tile is not None:
        lse, picked, argmax = nn.xent_pieces(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1), tile)
        picked = (picked - lse).reshape(labels.shape)
        argmax = argmax.reshape(labels.shape)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(-1, labels[..., None])[..., 0]
        argmax = logits.argmax(dim=-1)
    mask = (torch.ones(labels.shape, dtype=F32, device=labels.device)
            if mask is None else mask.to(F32))
    # the token group's mean count; a block of a sequence holds 1/count
    # of its replica's
    denom = torch.clamp(global_mean(torch.sum(mask)) * count, min=1.0)
    loss = -torch.sum(picked * mask) / denom
    loss = loss + moe_aux_weight * moe_aux
    acc = torch.sum((argmax == labels).to(F32) * mask) / denom
    return loss, {"accuracy": acc, "moe_aux": moe_aux}


def global_mean(count: torch.Tensor) -> torch.Tensor:
    """``count`` (no gradient) averaged over the token group of the
    train step's contexts (:func:`..parallel.collectives.batch_group`):
    the global batch's count over the ranks; ``count`` itself in one
    process."""
    group = collectives.batch_group()
    if collectives.size(group) == 1:
        return count
    return collectives.mean_(count.detach().clone(), group)


def synthetic_batch(generator: torch.Generator, batch_size: int,
                    seq_len: int = 128, vocab_size: int = 30522,
                    mask_rate: float = 0.15) -> Dict:
    """Uniform random ids and labels ``[B, S]`` (int64), a ``loss_mask``
    with about ``mask_rate`` of the positions on (fp32) and an all-ones
    int32 ``attention_mask``, drawn from ``generator`` on its device."""
    dev = generator.device
    shape = (batch_size, seq_len)
    ids = torch.randint(0, vocab_size, shape, generator=generator,
                        device=dev)
    labels = torch.randint(0, vocab_size, shape, generator=generator,
                           device=dev)
    loss_mask = torch.rand(shape, generator=generator, device=dev) < mask_rate
    return {
        "input_ids": ids,
        "labels": labels,
        "loss_mask": loss_mask.to(F32),
        "attention_mask": torch.ones(shape, dtype=torch.int32, device=dev),
    }
