"""ServingEngine — prefill + paged incremental decode over models/gpt.

The counterpart of ``paddle_operator_tpu/serving/engine.py``. After the
prompt is processed once (**prefill**), each new token needs only its OWN
query row against the cached K/V of everything before it (**decode**):

* **prefill** — one forward over the prompt padded to ``prompt_pad``
  (plain causal attention with a ``-1e30`` mask) that returns the
  per-layer K/V and the first greedy token; K/V land in the paged cache
  (:class:`.kv_cache.PagedKvCache`);
* **decode** — one step over the whole active batch padded to
  ``max_batch``: project q/k/v for the single new position (per-row
  rotary positions), write k/v into each sequence's current page slot,
  and attend through :func:`..ops.attention.paged_decode_attention` (the
  CUDA kernel; ``attn="reference"`` takes the plain gather-einsum path,
  which must give the same tokens).

Pad rows of the decode batch are inert: token 0 at position 0, written
into the cache's reserved dummy page, so every pad row writes the same
value there and no live block table can reference it.

The port has no jit: steps run eagerly under ``torch.inference_mode()``
in fp32, and each decode step reads its next tokens back with one
``.tolist()``. Sampling is greedy argmax, so the paged and reference
paths can be compared token for token.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops import nn
from ..ops.attention import _reference_paged_decode, paged_decode_attention
from .batching import Request
from .kv_cache import KvCacheFull, PagedKvCache

F32 = torch.float32


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


def _rope_rows(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding with PER-ROW positions: x [B, S, H, D],
    positions [B, S]. cos/sin are computed in fp32, then cast to
    ``x.dtype``."""
    half = x.shape[-1] // 2
    inv_freq = base ** (-torch.arange(0, half, dtype=F32,
                                      device=x.device) / half)
    ang = positions.float()[..., None] * inv_freq             # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _qkv(layer: Dict[str, Any], h: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mha projections with the head axis explicit (kernels are
    [dim, heads, head_dim])."""
    def proj(p: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.einsum("bsd,dhk->bshk", h, p["kernel"]) + p["bias"]

    attn = layer["attn"]
    return proj(attn["q"]), proj(attn["k"]), proj(attn["v"])


def _ffn(layer: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    z = nn.layernorm(layer["ln2"], x, dtype=F32)
    z = nn.dense(layer["mlp"]["fc1"], z, dtype=F32)
    z = nn.gelu(z)
    z = nn.dense(layer["mlp"]["fc2"], z, dtype=F32)
    return x + z


class ServingEngine:
    """One replica's model: gpt params + paged KV cache + step functions.

    ``attn="paged"`` uses the CUDA decode kernel on a CUDA device (its
    plain version on the CPU); ``attn="reference"`` uses the gather-einsum
    path. MoE configs are rejected up front. ``device=None`` means CUDA;
    the parameters are moved there.
    """

    def __init__(self, params: Any, config: Dict, max_batch: int = 8,
                 prompt_pad: int = 32, num_blocks: int = 256,
                 block_size: int = 16, attn: str = "paged",
                 eos_id: Optional[int] = None, label: str = "serve",
                 device: Union[str, torch.device, None] = None) -> None:
        if attn not in ("paged", "reference"):
            raise ValueError("attn must be paged|reference, got %r" % attn)
        if config.get("moe_experts"):
            raise ValueError("ServingEngine does not serve MoE configs")
        self.device = resolve_device(device, "ServingEngine")
        heads = config["heads"]
        head_dim = config["hidden"] // heads
        self.params = _to_device(params, self.device)
        self.config = dict(config)
        self.max_batch = max_batch
        self.prompt_pad = prompt_pad
        self.attn = attn
        self.eos_id = eos_id
        self.label = label
        #: pages one sequence may span — the decode block-table width
        self.pages_per_seq = -(-config["max_seq"] // block_size)
        self.cache = PagedKvCache(num_blocks, block_size,
                                  layers=config["layers"], heads=heads,
                                  head_dim=head_dim, dtype=F32,
                                  device=self.device)
        self._prefilled: Dict[str, bool] = {}
        #: batched decode steps run so far (each runs every layer once)
        self.decode_steps = 0

    # -- admission hooks (wired into ContinuousBatcher) ------------------

    def admit(self, req: Request) -> bool:
        """Reserve KV pages for the prompt plus the WHOLE token budget up
        front (a mid-generation KvCacheFull would strand a half-generated
        sequence); only the prompt is live until decode advances. False =
        pool exhausted, the batcher defers the request."""
        need = len(req.prompt) + req.max_new_tokens
        if need > self.config["max_seq"]:
            raise ValueError(
                "request %s needs %d tokens > max_seq %d"
                % (req.request_id, need, self.config["max_seq"]))
        # validate the prompt BEFORE reserving: a reject after
        # alloc_sequence succeeded would leak the reservation (the request
        # never reaches retire)
        if not 0 < len(req.prompt) <= self.prompt_pad:
            raise ValueError(
                "request %s prompt length %d outside (0, %d]"
                % (req.request_id, len(req.prompt), self.prompt_pad))
        try:
            self.cache.allocator.alloc_sequence(
                req.request_id, need, live_tokens=len(req.prompt))
        except KvCacheFull:
            return False
        return True

    def retire(self, req: Request) -> None:
        self.cache.allocator.free_sequence(req.request_id)
        self._prefilled.pop(req.request_id, None)

    # -- the batcher-facing step ----------------------------------------

    def step_fn(self, active: List[Request]) -> List[Tuple[int, bool]]:
        """One engine iteration for the batcher's active set: prefill
        newly admitted sequences (their first token comes from the
        prefill logits), then one batched decode step for the rest."""
        if len(active) > self.max_batch:
            raise RuntimeError("active set %d exceeds max_batch %d"
                               % (len(active), self.max_batch))
        results: Dict[str, Tuple[int, bool]] = {}
        decode_rows: List[Request] = []
        for req in active:
            if not self._prefilled.get(req.request_id):
                token = self._prefill(req)
                results[req.request_id] = (token, token == self.eos_id)
                self._prefilled[req.request_id] = True
            else:
                decode_rows.append(req)
        if decode_rows:
            for req, token in zip(decode_rows, self._decode(decode_rows)):
                results[req.request_id] = (token, token == self.eos_id)
        return [results[r.request_id] for r in active]

    # -- prefill -----------------------------------------------------------

    @torch.inference_mode()
    def prefill_forward(self, ids: torch.Tensor, length: int
                        ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                   List[torch.Tensor]]:
        """ids [1, pad] zero-padded, ``length`` real tokens -> (logits [V]
        at position ``length - 1``, [k per layer], [v per layer]) with k/v
        shaped [pad, H, Dh]. Plain causal attention: prefill sees the
        whole prompt, so the training-style full-sequence path is right."""
        params = self.params
        pad = ids.shape[1]
        x = nn.embedding(params["embed"]["tok"], ids, F32)
        positions = torch.arange(pad, device=self.device)[None, :]
        cmask = torch.tril(torch.ones((pad, pad), dtype=torch.bool,
                                      device=self.device))[None, None]
        ks, vs = [], []
        for layer in params["layers"]:
            h = nn.layernorm(layer["ln1"], x, dtype=F32)
            q, k, v = _qkv(layer, h)
            q = _rope_rows(q, positions)
            k = _rope_rows(k, positions)
            ks.append(k[0])
            vs.append(v[0])
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) \
                / math.sqrt(q.shape[-1])
            scores = torch.where(cmask, scores, torch.full_like(scores,
                                                                -1e30))
            probs = torch.softmax(scores.float(), dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
            y = torch.einsum("bqhd,hdo->bqo", ctx,
                             layer["attn"]["o"]["kernel"]) \
                + layer["attn"]["o"]["bias"]
            x = _ffn(layer, x + y)
        x = nn.layernorm(params["final_ln"], x, dtype=F32)
        last = x[0, length - 1]
        logits = nn.dense(params["lm_head"], last[None], dtype=F32)[0]
        return logits, ks, vs

    def _prefill(self, req: Request) -> int:
        n = len(req.prompt)
        if not 0 < n <= self.prompt_pad:
            raise ValueError("prompt length %d outside (0, %d]"
                             % (n, self.prompt_pad))
        ids = torch.zeros((1, self.prompt_pad), dtype=torch.long)
        ids[0, :n] = torch.as_tensor(list(req.prompt), dtype=torch.long)
        logits, ks, vs = self.prefill_forward(ids.to(self.device), n)
        with torch.inference_mode():
            for li in range(self.config["layers"]):
                self.cache.write_prefill(req.request_id, li, ks[li][:n],
                                         vs[li][:n])
            return int(torch.argmax(logits))

    # -- decode ------------------------------------------------------------

    @torch.inference_mode()
    def decode_forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                       blocks: torch.Tensor, slots: torch.Tensor,
                       tables: torch.Tensor, lens: torch.Tensor
                       ) -> torch.Tensor:
        """One token for every row: tokens [B] (each row's last sampled
        token), positions [B] (its 0-based index), blocks/slots [B] (the
        page and slot its k/v go to), tables [B, T] int32, lens [B] int32
        (live cache tokens AFTER this step's write). Writes k/v into the
        cache in place and returns the next greedy tokens [B]."""
        params = self.params
        x = nn.embedding(params["embed"]["tok"], tokens.long()[:, None],
                         F32)                                     # [B,1,D]
        pos2 = positions[:, None]
        idx = (blocks.long(), slots.long())
        for li, layer in enumerate(params["layers"]):
            h = nn.layernorm(layer["ln1"], x, dtype=F32)
            q, k, v = _qkv(layer, h)
            q = _rope_rows(q, pos2)
            k = _rope_rows(k, pos2)
            kp = self.cache.k_pages[li].index_put_(idx, k[:, 0])
            vp = self.cache.v_pages[li].index_put_(idx, v[:, 0])
            if self.attn == "paged":
                ctx = paged_decode_attention(q[:, 0], kp, vp, tables, lens)
            else:
                ctx = _reference_paged_decode(
                    q[:, 0], kp, vp, tables, lens,
                    1.0 / math.sqrt(q.shape[-1]))
            y = torch.einsum("bhd,hdo->bo", ctx.float(),
                             layer["attn"]["o"]["kernel"]) \
                + layer["attn"]["o"]["bias"]
            x = _ffn(layer, x + y[:, None])
        x = nn.layernorm(params["final_ln"], x, dtype=F32)
        logits = nn.dense(params["lm_head"], x[:, 0], dtype=F32)  # [B,V]
        return torch.argmax(logits, dim=-1)

    def _decode(self, rows: List[Request]) -> List[int]:
        alloc = self.cache.allocator
        bs = alloc.block_size
        b, t = self.max_batch, self.pages_per_seq
        # one host buffer, one copy to the device: tokens, positions,
        # blocks, slots, lens [B] each, then tables [B, T]. Pad rows keep
        # token 0 at position 0, aimed at the dummy page's slot 0, with a
        # zero table and one live token.
        host = np.zeros(5 * b + b * t, dtype=np.int32)
        tokens, positions, blocks, slots, lens = (
            host[i * b:(i + 1) * b] for i in range(5))
        tables = host[5 * b:].reshape(b, t)
        blocks[:] = self.cache.dummy_page
        lens[:] = 1
        for i, req in enumerate(rows):
            sid = req.request_id
            tokens[i] = req.generated[-1]
            pos = alloc.advance(sid)     # the slot reserved for this token
            table = alloc.block_table(sid)
            positions[i] = pos
            blocks[i] = table[pos // bs]
            slots[i] = pos % bs
            lens[i] = pos + 1
            tables[i, :len(table)] = table
        dev = torch.from_numpy(host).to(self.device)
        self.decode_steps += 1
        cols = [dev[i * b:(i + 1) * b] for i in range(5)]
        out = self.decode_forward(*cols[:4], dev[5 * b:].view(b, t), cols[4])
        return out.tolist()[:len(rows)]
