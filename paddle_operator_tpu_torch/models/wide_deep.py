"""wide_and_deep CTR model: the port of
``paddle_operator_tpu/models/wide_deep.py``, the reference's PS-mode
acceptance workload (``deploy/examples/wide_and_deep.yaml``). Sparse
slot embeddings, a wide linear part and a deep MLP; sigmoid BCE on click
labels.

The tree has the reference's keys (``dense_proj``, ``mlp[i]``, ``out``,
``embed``, ``wide``) and layouts, so a JAX-initialised tree runs here
through :mod:`..bridge` unchanged. Slot ids are folded into one shared
table slot-major (row = slot * vocab_per_slot + id).

The sparse-PS variant (:func:`sparse_loss_fn`) reads only the rows a
batch touches, pulled from the parameter servers (:mod:`..ps`): one fused
server table of width ``embed_dim + 1`` carries the deep embedding and
the wide weight of an id, so a round is one sparse pull and one push.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops import nn

DEFAULT_CONFIG = dict(
    num_slots=26,          # criteo-style categorical slots
    vocab_per_slot=10000,
    embed_dim=16,
    dense_dim=13,          # continuous features
    hidden=[400, 400, 400],
)


def init_dense(generator: torch.Generator,
               config: Optional[dict] = None) -> Dict:
    """The non-embedding parameters only: what the dense BSP vector
    carries in sparse-PS mode (the tables never leave the servers)."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    params: Dict = {
        "dense_proj": nn.dense_init(generator, cfg["dense_dim"],
                                    cfg["embed_dim"]),
        "mlp": [],
    }
    in_dim = cfg["embed_dim"] * (cfg["num_slots"] + 1)
    for h in cfg["hidden"]:
        params["mlp"].append(nn.dense_init(generator, in_dim, h))
        in_dim = h
    params["out"] = nn.dense_init(generator, in_dim, 1)
    return params


def init(generator: torch.Generator, config: Optional[dict] = None) -> Dict:
    """Random fp32 parameters drawn from ``generator``, on its device: one
    table shared by the slots for the deep embedding, one for the wide
    weight."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    params = init_dense(generator, cfg)
    rows = cfg["num_slots"] * cfg["vocab_per_slot"]
    params["embed"] = nn.embedding_init(generator, rows, cfg["embed_dim"])
    params["wide"] = nn.embedding_init(generator, rows, 1)
    return params


def _fold_slots(sparse_ids: torch.Tensor, vocab_per_slot: int
                ) -> torch.Tensor:
    num_slots = sparse_ids.shape[-1]
    offsets = torch.arange(num_slots, device=sparse_ids.device,
                           dtype=sparse_ids.dtype) * vocab_per_slot
    return sparse_ids + offsets[None, :]


def ctr_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Sigmoid BCE and accuracy (``logits > 0`` against the label): the
    loss tail of every CTR model's dense and sparse forwards."""
    loss = nn.sigmoid_binary_cross_entropy(logits, labels)
    pred = (logits > 0).float()
    acc = (pred == labels.float()).float().mean()
    return loss, {"accuracy": acc}


def _deep_logit(params: Dict, emb: torch.Tensor, dense_feat: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The deep tower of the dense and sparse-PS forwards:
    concat(flattened slot embeddings, projected dense features) -> MLP ->
    one fp32 logit a row."""
    b = emb.shape[0]
    deep = torch.cat([emb.reshape(b, -1), dense_feat], dim=-1)
    for layer in params["mlp"]:
        deep = torch.relu(nn.dense(layer, deep, dtype))
    return nn.dense(params["out"], deep, torch.float32)[:, 0]


def apply(params: Dict, batch: Dict,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``batch = {"sparse": int [B, num_slots], "dense": float [B,
    dense_dim]}`` -> fp32 logits ``[B]``."""
    # rows are laid out slot-major, so rows-per-slot falls out of the shape
    vocab_per_slot = params["embed"]["table"].shape[0] \
        // batch["sparse"].shape[-1]
    ids = _fold_slots(batch["sparse"], vocab_per_slot)
    emb = nn.embedding(params["embed"], ids, dtype)               # [B, S, E]
    wide = nn.embedding(params["wide"], ids, torch.float32)       # [B, S, 1]
    dense_feat = nn.dense(params["dense_proj"], batch["dense"], dtype)
    wide_logit = wide[..., 0].sum(dim=-1)
    return _deep_logit(params, emb, dense_feat, dtype) + wide_logit


def sparse_row_dim(config: Optional[dict] = None) -> int:
    """Width of a server-side row: the deep embedding and the wide weight."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    return cfg["embed_dim"] + 1


def sparse_ids(batch: Dict, vocab_per_slot: int) -> np.ndarray:
    """The slot-folded row ids a batch touches, raveled, as host int64:
    the trainer's ``ids_fn`` for :class:`..ps.PsTrainJob`."""
    ids = _fold_slots(torch.as_tensor(batch["sparse"]), vocab_per_slot)
    return ids.cpu().numpy().astype(np.int64).ravel()


def sparse_loss_fn(params: Dict, rows: torch.Tensor, inv: torch.Tensor,
                   batch: Dict, train: bool = True,
                   dtype: torch.dtype = torch.bfloat16):
    """:func:`loss_fn`'s math with the embedding lookup ``rows[inv]`` over
    the PULLED rows (``rows``: fp32 ``[n, embed_dim + 1]``, the last column
    the wide weight; ``inv``: ``[B * S]`` local indices)."""
    b, s = batch["sparse"].shape
    picked = rows[inv].reshape(b, s, -1)         # [B, S, E+1]
    emb = picked[..., :-1].to(dtype)             # [B, S, E]
    wide = picked[..., -1].float()               # [B, S]
    dense_feat = nn.dense(params["dense_proj"], batch["dense"], dtype)
    logits = _deep_logit(params, emb, dense_feat, dtype) + wide.sum(dim=-1)
    return ctr_loss(logits, batch["label"])


def loss_fn(params: Dict, batch: Dict, train: bool = True,
            dtype: torch.dtype = torch.bfloat16):
    return ctr_loss(apply(params, batch, dtype), batch["label"])


def synthetic_batch(generator: torch.Generator, batch_size: int,
                    config: Optional[dict] = None) -> Dict:
    """Uniform slot ids (int64 ``[B, num_slots]``), normal dense features
    (fp32 ``[B, dense_dim]``) and fair-coin labels (int32 ``[B]``), drawn
    from ``generator`` on its device."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    dev = generator.device
    return {
        "sparse": torch.randint(0, cfg["vocab_per_slot"],
                                (batch_size, cfg["num_slots"]),
                                generator=generator, device=dev),
        "dense": torch.randn((batch_size, cfg["dense_dim"]),
                             generator=generator, device=dev),
        "label": (torch.rand((batch_size,), generator=generator, device=dev)
                  < 0.5).to(torch.int32),
    }
