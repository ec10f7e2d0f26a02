"""DeepFM CTR model: the port of ``paddle_operator_tpu/models/deepfm.py``,
the reference's second PS-mode workload (``deploy/examples/deepfm.yaml``):
FM first- and second-order terms and a deep MLP, with the keys
(``dense_w``, ``mlp[i]``, ``out``, ``fm_first``, ``fm_embed``) and layouts
of the reference's tree.

The FM second-order term ``0.5 ((Σv)² - Σv²)`` is computed in the compute
type (bf16 by default) and cast to fp32 afterwards, as the reference
computes it; under bf16 the difference cancels badly, and the port keeps
that.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops import nn
# same input schema and sparse-PS helpers as wide_deep (shared slot-id
# folding and fused row layout)
from .wide_deep import (  # noqa: F401
    DEFAULT_CONFIG, _fold_slots, ctr_loss, sparse_ids, sparse_row_dim,
    synthetic_batch)


def init_dense(generator: torch.Generator,
               config: Optional[dict] = None) -> Dict:
    """The non-embedding parameters only: the dense BSP vector in
    sparse-PS mode (the FM tables stay row-sharded on the servers)."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    params: Dict = {
        "dense_w": nn.dense_init(generator, cfg["dense_dim"], 1),
        "mlp": [],
    }
    in_dim = cfg["embed_dim"] * cfg["num_slots"] + cfg["dense_dim"]
    for h in cfg["hidden"]:
        params["mlp"].append(nn.dense_init(generator, in_dim, h))
        in_dim = h
    params["out"] = nn.dense_init(generator, in_dim, 1)
    return params


def init(generator: torch.Generator, config: Optional[dict] = None) -> Dict:
    """Random fp32 parameters drawn from ``generator``, on its device."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    vocab = cfg["num_slots"] * cfg["vocab_per_slot"]
    params = init_dense(generator, cfg)
    params["fm_first"] = nn.embedding_init(generator, vocab, 1)
    params["fm_embed"] = nn.embedding_init(generator, vocab,
                                           cfg["embed_dim"])
    return params


def _logits(params: Dict, emb: torch.Tensor, first_order: torch.Tensor,
            batch: Dict, dtype: torch.dtype) -> torch.Tensor:
    """FM second order + deep tower, shared by the dense and sparse-PS
    forwards. ``emb``: ``[B, S, E]`` in ``dtype``; ``first_order``:
    ``[B]`` fp32 (the slot weights summed)."""
    first = first_order + nn.dense(params["dense_w"], batch["dense"],
                                   torch.float32)[:, 0]

    # FM second order: 0.5 * ((Σv)² - Σv²), in the compute type
    sum_sq = torch.square(emb.sum(dim=1))
    sq_sum = torch.square(emb).sum(dim=1)
    second = (0.5 * (sum_sq - sq_sum).sum(dim=-1)).float()

    b = emb.shape[0]
    deep = torch.cat([emb.reshape(b, -1), batch["dense"].to(dtype)], dim=-1)
    for layer in params["mlp"]:
        deep = torch.relu(nn.dense(layer, deep, dtype))
    deep_logit = nn.dense(params["out"], deep, torch.float32)[:, 0]
    return first + second + deep_logit


def apply(params: Dict, batch: Dict,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    vocab_per_slot = params["fm_embed"]["table"].shape[0] \
        // batch["sparse"].shape[-1]
    ids = _fold_slots(batch["sparse"], vocab_per_slot)
    emb = nn.embedding(params["fm_embed"], ids, dtype)        # [B, S, E]
    first = nn.embedding(params["fm_first"], ids,
                         torch.float32)[..., 0].sum(dim=-1)
    return _logits(params, emb, first, batch, dtype)


def sparse_loss_fn(params: Dict, rows: torch.Tensor, inv: torch.Tensor,
                   batch: Dict, train: bool = True,
                   dtype: torch.dtype = torch.bfloat16):
    """Sparse-PS forward: one fused server table of width ``embed_dim +
    1`` carries ``[fm_embed | fm_first]`` a row; the lookup is
    ``rows[inv]`` over the pulled rows (the same contract as
    ``wide_deep.sparse_loss_fn``)."""
    b, s = batch["sparse"].shape
    picked = rows[inv].reshape(b, s, -1)          # [B, S, E+1]
    emb = picked[..., :-1].to(dtype)              # [B, S, E]
    first = picked[..., -1].float().sum(dim=-1)   # [B]
    return ctr_loss(_logits(params, emb, first, batch, dtype),
                    batch["label"])


def loss_fn(params: Dict, batch: Dict, train: bool = True,
            dtype: torch.dtype = torch.bfloat16):
    return ctr_loss(apply(params, batch, dtype), batch["label"])
