"""Decoder-only causal LM (GPT family), the counterpart of
``paddle_operator_tpu/models/gpt.py``: forward, training loss and
synthetic batches.

Pre-LN blocks with rotary embeddings; the parameter tree has the JAX
package's keys and layouts (``embed.tok.table``, ``layers[i].{ln1, attn,
ln2, mlp.{fc1, fc2}}``, ``final_ln``, ``lm_head`` without bias), so a tree
initialised by the JAX package and converted by :mod:`..bridge` runs here
unchanged. Compute is in ``dtype`` (bf16 by default) on the tree's fp32
parameters; attention is ``nn.mha(impl=attn_impl, causal=True)``, which
with "auto" runs the flash kernels for CUDA tensors. ``remat`` recomputes
each block in the backward (``torch.utils.checkpoint``, non-reentrant, so
``torch.autograd.grad`` works through it).

With ``moe_experts > 0`` every ``moe_every``-th FFN (layers ``li %
moe_every == 0``) is a switch-MoE block, ``layers[i].moe.{router, wi,
wo}`` (:mod:`..ops.moe`); ``encode`` and ``apply`` return the layers'
load-balancing loss beside their output, as the reference's do. Across
worker processes the MoE layers route over the global batch and, under
``ep``, run this rank's experts (:func:`..parallel.collectives.
moe_split`, read once a forward and handed to every block, since remat's
recompute runs outside the train step's contexts).

Under a sequence split (the train step's ``seq_axis``: :func:`..parallel.
collectives.sequence_shards`) :func:`loss_fn` takes this rank's block of
every sequence from a batch whose token axis is whole, and gives its part
of the reference's loss on the global arrays: rope at global positions,
the labels shifted across the block boundary (only the last block drops
its final position), and the whole sequence's mask sum as denominator,
so the blocks' losses and accuracies add up to the replica's. Attention
across blocks is the caller's ``attn_impl`` (ring or Ulysses attention
over the same axis).

Under tensor parallelism (the train step's ``tp`` axis with
``gpt_rules``: :func:`..parallel.collectives.model_tiles`) each rank
holds the tiles the rules split: its heads of each attention layer and
its columns of ``fc1`` (column-parallel), the matching rows of ``o`` and
``fc2`` (row-parallel, their biases added once after the sum over tp),
its rows of the token embedding (a vocabulary-parallel lookup) and its
columns of the LM head (a vocabulary-parallel cross-entropy, no
``[tokens, V]`` logits gathered). Which leaves are split comes from the
step's layout in :attr:`..parallel.collectives.Split.tiles`, a leaf at a
time (:func:`..ops.nn.split_group`), since a rule whose dimension does
not divide falls back to replicated.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import nn
from ..ops.moe import moe_apply, moe_init
from ..parallel import collectives

F32 = torch.float32

BASE_CONFIG = dict(      # GPT-2 small scale
    vocab_size=50304, hidden=768, layers=12, heads=12, mlp_dim=3072,
    max_seq=1024, moe_experts=0, moe_every=2,
)

TINY_CONFIG = dict(
    vocab_size=1024, hidden=128, layers=2, heads=4, mlp_dim=256,
    max_seq=256, moe_experts=0, moe_every=2,
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
        "embed": {"tok": nn.embedding_init(generator, cfg["vocab_size"], h)},
        "layers": [],
        "final_ln": nn.layernorm_init(h, dev),
        "lm_head": nn.dense_init(generator, h, cfg["vocab_size"],
                                 use_bias=False),
    }
    for li in range(cfg["layers"]):
        layer = {
            "ln1": nn.layernorm_init(h, dev),
            "attn": nn.mha_init(generator, h, cfg["heads"]),
            "ln2": nn.layernorm_init(h, dev),
        }
        if cfg["moe_experts"] and li % cfg["moe_every"] == 0:
            layer["moe"] = moe_init(generator, h, mlp, cfg["moe_experts"])
        else:
            layer["mlp"] = {"fc1": nn.dense_init(generator, h, mlp),
                            "fc2": nn.dense_init(generator, mlp, h)}
        params["layers"].append(layer)
    return params


def _block(layer: Dict, x: torch.Tensor, dtype: torch.dtype, attn_impl: Any,
           positions: Optional[torch.Tensor],
           split: Optional[collectives.Split] = None, prefix: str = ""
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-LN decoder block: x + attn(ln1 x); x + ffn(ln2 x). Returns
    ``(x, aux)``, aux the MoE load-balancing loss (0 for a dense FFN).
    ``prefix``: the layer's path in the tree (``layers/3/``), for its
    tiles in ``split``."""
    causal = not callable(attn_impl)  # callables (ring/ulysses) own masking
    y = nn.mha(layer["attn"], nn.layernorm(layer["ln1"], x, dtype=dtype),
               dtype=dtype, impl=attn_impl, causal=causal, use_rope=True,
               positions=positions,
               tp=nn.split_group(split, prefix + "attn/", nn.MHA_TILES))
    x = x + y
    z = nn.layernorm(layer["ln2"], x, dtype=dtype)
    aux = torch.zeros((), dtype=F32, device=x.device)
    if "moe" in layer:
        z, moe_aux = moe_apply(layer["moe"], z, dtype=dtype, split=split)
        aux = aux + moe_aux["moe_aux_loss"]
    else:
        tp = nn.split_group(split, prefix + "mlp/", nn.MLP_TILES)
        z = nn.column_dense(layer["mlp"]["fc1"], z, dtype, tp)
        z = nn.gelu(z)
        z = nn.row_dense(layer["mlp"]["fc2"], z, dtype, tp)
    return x + z, aux


def encode(params: Dict, input_ids: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16, remat: bool = False,
           attn_impl: Any = "auto",
           positions: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone up to (but excluding) the LM head: [B, S] ids -> ([B, S,
    D] final-LN hidden states in ``dtype``, the layers' MoE aux loss summed
    in fp32)."""
    split = collectives.moe_split()
    x = nn.embedding(params["embed"]["tok"], input_ids, dtype,
                     split.tile("embed/tok/table"))
    aux = torch.zeros((), dtype=F32, device=input_ids.device)
    for li, layer in enumerate(params["layers"]):
        prefix = "layers/%d/" % li
        if remat:
            x, layer_aux = checkpoint(_block, layer, x, dtype, attn_impl,
                                      positions, split, prefix,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            x, layer_aux = _block(layer, x, dtype, attn_impl, positions,
                                  split, prefix)
        aux = aux + layer_aux
    return nn.layernorm(params["final_ln"], x, dtype=dtype), aux


def apply(params: Dict, input_ids: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16, remat: bool = False,
          attn_impl: Any = "auto",
          positions: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_ids: [B, S] -> (logits [B, S, V] in fp32 (the LM head runs in
    fp32, as the reference's), MoE aux loss). With the LM head split over
    tp (:func:`..parallel.collectives.model_tiles`), this rank's columns
    ``[B, S, V/n]``."""
    x, aux = encode(params, input_ids, dtype=dtype, remat=remat,
                    attn_impl=attn_impl, positions=positions)
    tile = collectives.moe_split().tile("lm_head/kernel")
    if tile is not None:
        return nn.column_dense(params["lm_head"], x, F32, tile.group), aux
    return nn.dense(params["lm_head"], x, dtype=F32), aux


def block_positions(index: int, s_local: int,
                    device: torch.device) -> torch.Tensor:
    """Global token positions of block ``index`` of ``s_local`` tokens."""
    return index * s_local + torch.arange(s_local, device=device)


def loss_fn(params: Dict, batch: Dict, train: bool = True,
            dtype: torch.dtype = torch.bfloat16, remat: bool = False,
            attn_impl: Any = "auto", moe_aux_weight: float = 0.01,
            ce_chunk: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Next-token LM loss. batch = {"input_ids" [B, S], optional
    "loss_mask"}: labels are the ids shifted left (the last position is
    dropped) and a ``loss_mask`` applies at the label position.
    ``ce_chunk > 0`` streams the LM head through
    :func:`..ops.nn.chunked_lm_xent` (no ``[B, S, V]`` logits); 0 takes
    the dense fp32 head. Returns ``(loss, {"accuracy", "moe_aux"})``; the
    loss includes ``moe_aux_weight * moe_aux``.

    Under a sequence split of n blocks (``collectives.seq_block()``) the
    batch's token axis is whole; this rank runs block i of the ids at
    positions ``i S/n + arange(S/n)``, and its loss and accuracy are the
    block's sums over the whole sequence's masked label count."""
    ids = batch["input_ids"]
    labels = ids[:, 1:].long()
    mask = batch.get("loss_mask")
    mask = (torch.ones(labels.shape, dtype=F32, device=ids.device)
            if mask is None else mask[:, 1:].to(F32))
    index, count = collectives.seq_block()
    positions, denom = None, None
    if count > 1:
        if ids.shape[1] % count:
            raise ValueError("seq len %d must divide ring size %d"
                             % (ids.shape[1], count))
        s_local = ids.shape[1] // count
        start = index * s_local
        denom = torch.clamp(torch.sum(mask), min=1.0)
        positions = block_positions(index, s_local, ids.device)
        ids = ids[:, start:start + s_local]
        # the next block's first token labels this block's last one;
        # the last block has one label fewer
        labels = labels[:, start:start + s_local]
        mask = mask[:, start:start + s_local]
    n_labels = labels.shape[1]

    tile = collectives.moe_split().tile("lm_head/kernel")
    if ce_chunk:
        hidden, moe_aux = encode(params, ids, dtype=dtype, remat=remat,
                                 attn_impl=attn_impl, positions=positions)
        loss, acc = nn.chunked_lm_xent(params["lm_head"],
                                       hidden[:, :n_labels], labels,
                                       mask=mask, chunk=ce_chunk,
                                       dtype=dtype, denom=denom, tile=tile)
        loss = loss + moe_aux_weight * moe_aux
        return loss, {"accuracy": acc, "moe_aux": moe_aux}

    logits, moe_aux = apply(params, ids, dtype=dtype, remat=remat,
                            attn_impl=attn_impl, positions=positions)
    logits = logits[:, :n_labels]
    if denom is None:
        denom = torch.clamp(torch.sum(mask), min=1.0)
    if tile is not None:
        lse, picked, argmax = nn.xent_pieces(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1), tile)
        picked = (picked - lse).reshape(labels.shape)
        argmax = argmax.reshape(labels.shape)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(-1, labels[..., None])[..., 0]
        argmax = logits.argmax(dim=-1)
    loss = -torch.sum(picked * mask) / denom
    loss = loss + moe_aux_weight * moe_aux
    acc = torch.sum((argmax == labels).to(F32) * mask) / denom
    return loss, {"accuracy": acc, "moe_aux": moe_aux}


def synthetic_batch(generator: torch.Generator, batch_size: int,
                    seq_len: int = 256, vocab_size: int = 50304) -> Dict:
    """Uniform random token ids ``[B, S]`` drawn from ``generator`` on its
    device."""
    ids = torch.randint(0, vocab_size, (batch_size, seq_len),
                        generator=generator, device=generator.device)
    return {"input_ids": ids}
