"""Decoder-only causal LM (GPT family), the counterpart of
``paddle_operator_tpu/models/gpt.py`` on the einsum attention path.

Pre-LN blocks with rotary embeddings; the parameter tree has the JAX
package's keys and layouts (``embed.tok.table``, ``layers[i].{ln1, attn,
ln2, mlp.{fc1, fc2}}``, ``final_ln``, ``lm_head`` without bias), so a tree
initialised by the JAX package and converted by :mod:`..bridge` runs here
unchanged. MoE configs are refused: the port has no MoE layers yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops import nn

F32 = torch.float32

BASE_CONFIG = dict(      # GPT-2 small scale
    vocab_size=50304, hidden=768, layers=12, heads=12, mlp_dim=3072,
    max_seq=1024, moe_experts=0, moe_every=2,
)

TINY_CONFIG = dict(
    vocab_size=1024, hidden=128, layers=2, heads=4, mlp_dim=256,
    max_seq=256, moe_experts=0, moe_every=2,
)


def init(generator: torch.Generator, config: Optional[dict] = None) -> Dict:
    """Random parameters drawn from ``generator``, on its device. The
    numbers differ from the JAX package's for the same seed; tests that
    compare the two start from a JAX-initialised tree."""
    cfg = dict(BASE_CONFIG, **(config or {}))
    if cfg["moe_experts"]:
        raise ValueError("the torch port has no MoE layers (moe_experts=%d)"
                         % cfg["moe_experts"])
    h, mlp = cfg["hidden"], cfg["mlp_dim"]
    dev = generator.device
    params: Dict = {
        "embed": {"tok": nn.embedding_init(generator, cfg["vocab_size"], h)},
        "layers": [],
        "final_ln": nn.layernorm_init(h, dev),
        "lm_head": nn.dense_init(generator, h, cfg["vocab_size"],
                                 use_bias=False),
    }
    for _ in range(cfg["layers"]):
        params["layers"].append({
            "ln1": nn.layernorm_init(h, dev),
            "attn": nn.mha_init(generator, h, cfg["heads"]),
            "ln2": nn.layernorm_init(h, dev),
            "mlp": {"fc1": nn.dense_init(generator, h, mlp),
                    "fc2": nn.dense_init(generator, mlp, h)},
        })
    return params


def _block(layer: Dict, x: torch.Tensor) -> torch.Tensor:
    """Pre-LN decoder block: x + attn(ln1 x); x + ffn(ln2 x)."""
    y = nn.mha(layer["attn"], nn.layernorm(layer["ln1"], x, dtype=F32),
               dtype=F32, causal=True, use_rope=True)
    x = x + y
    z = nn.layernorm(layer["ln2"], x, dtype=F32)
    z = nn.dense(layer["mlp"]["fc1"], z, dtype=F32)
    z = nn.gelu(z)
    z = nn.dense(layer["mlp"]["fc2"], z, dtype=F32)
    return x + z


def encode(params: Dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Backbone up to (but excluding) the LM head, in fp32: [B, S] ids ->
    [B, S, D] final-LN hidden states."""
    x = nn.embedding(params["embed"]["tok"], input_ids, F32)
    for layer in params["layers"]:
        x = _block(layer, x)
    return nn.layernorm(params["final_ln"], x, dtype=F32)


def apply(params: Dict, input_ids: torch.Tensor) -> torch.Tensor:
    """input_ids: [B, S] -> logits [B, S, V] in fp32 (the JAX ``apply``
    with ``dtype=float32, attn_impl="einsum"``, without its MoE aux
    loss)."""
    return nn.dense(params["lm_head"], encode(params, input_ids), dtype=F32)
