"""Paged KV-cache: a block-table allocator over fixed-size token pages.

Contiguous per-sequence KV buffers waste HBM quadratically under
continuous batching: every admitted sequence would reserve ``max_seq``
slots up front, and a mid-batch finish leaves an unusable hole. Paging
(the vLLM design) fixes both: the cache is a pool of fixed-size blocks
(``block_size`` token slots each), a sequence owns a *block table* — an
ordered list of block ids — and grows one block at a time, so the only
internal fragmentation is the unfilled tail of each sequence's last
block.

:class:`KvBlockAllocator` is the bookkeeping half (pure Python, no
tensors): alloc/append/free with conservation invariants, a copy of the
JAX package's allocator. :class:`PagedKvCache` is the tensor half: the
``[num_blocks + 1, block_size, heads, head_dim]`` K/V pages per layer
that :func:`..ops.attention.paged_decode_attention` consumes, plus the
writes that fill them during prefill / decode.

Thread safety: every allocator field is owned by ``_lock``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Union

import torch

from ..device import resolve_device


class KvCacheFull(Exception):
    """No free block — the admission layer must shed, not crash."""


class KvBlockAllocator:
    """Block-table bookkeeping for a pool of ``num_blocks`` KV pages.

    Invariants (asserted by :meth:`check`):

    * every block is either in the free list or in exactly one
      sequence's table — no leak, no double-own;
    * ``len(table) * block_size >= seq_len`` and
      ``(len(table) - 1) * block_size < seq_len`` — tables are exactly
      as long as the tokens need, never longer;
    * fragmentation is only ever tail slack:
      ``waste == Σ (len(table) * block_size - seq_len)``.
    """

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._lock = threading.Lock()
        # LIFO free list: a just-freed (hot) block is reused first
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: Dict[str, List[int]] = {}
        self._lens: Dict[str, int] = {}
        self._reserved: Dict[str, int] = {}
        self._peak_used = 0

    # -- allocation ------------------------------------------------------

    def alloc_sequence(self, seq_id: str, num_tokens: int,
                       live_tokens: Optional[int] = None) -> List[int]:
        """Reserve blocks for ``num_tokens`` token slots. All-or-nothing:
        on pool exhaustion nothing is allocated and :class:`KvCacheFull`
        is raised (the batcher sheds or defers).

        ``live_tokens`` (default ``num_tokens``) is the FILLED length the
        sequence starts at — the serving engine reserves the prompt plus
        the whole generation budget up front (a mid-generation
        KvCacheFull would strand a half-generated sequence) but only the
        prompt is live after prefill; :meth:`advance` grows the live
        length one decode step at a time."""
        if num_tokens <= 0:
            raise ValueError("num_tokens must be positive")
        live = num_tokens if live_tokens is None else live_tokens
        if not 0 < live <= num_tokens:
            raise ValueError("live_tokens %r outside (0, %d]"
                             % (live_tokens, num_tokens))
        need = -(-num_tokens // self.block_size)
        with self._lock:
            if seq_id in self._tables:
                raise ValueError("sequence %r already allocated" % seq_id)
            if need > len(self._free):
                raise KvCacheFull(
                    "need %d block(s) for %d token(s), %d free"
                    % (need, num_tokens, len(self._free)))
            table = [self._free.pop() for _ in range(need)]
            self._tables[seq_id] = table
            self._lens[seq_id] = live
            self._reserved[seq_id] = num_tokens
            self._peak_used = max(self._peak_used,
                                  self.num_blocks - len(self._free))
            return list(table)

    def advance(self, seq_id: str) -> int:
        """Grow the live length into the pre-reserved slots by one token
        (the decode-step path); returns the new token's 0-based position.
        Raises when the reservation is exhausted — the batcher's token
        budget should have retired the sequence first."""
        with self._lock:
            if seq_id not in self._tables:
                raise KeyError("unknown sequence %r" % seq_id)
            if self._lens[seq_id] >= self._reserved[seq_id]:
                raise KvCacheFull(
                    "sequence %r exhausted its %d reserved slot(s)"
                    % (seq_id, self._reserved[seq_id]))
            pos = self._lens[seq_id]
            self._lens[seq_id] = pos + 1
            return pos

    def append_token(self, seq_id: str) -> Optional[int]:
        """Grow ``seq_id`` by one token slot, extending the reservation.
        Returns the newly allocated block id when the token crossed a
        block boundary, else None. Raises :class:`KvCacheFull` (sequence
        unchanged) on exhaustion. The incremental-growth counterpart of
        the up-front reservation: callers pick one style per sequence."""
        with self._lock:
            if seq_id not in self._tables:
                raise KeyError("unknown sequence %r" % seq_id)
            if self._lens[seq_id] < self._reserved[seq_id]:
                # still inside the reservation: no new block needed
                self._lens[seq_id] += 1
                return None
            if self._reserved[seq_id] % self.block_size == 0:
                # table exactly full: the next token needs a fresh block
                if not self._free:
                    raise KvCacheFull("no free block for %r" % seq_id)
                block = self._free.pop()
                self._tables[seq_id].append(block)
                self._lens[seq_id] += 1
                self._reserved[seq_id] += 1
                self._peak_used = max(self._peak_used,
                                      self.num_blocks - len(self._free))
                return block
            self._lens[seq_id] += 1
            self._reserved[seq_id] += 1
            return None

    def free_sequence(self, seq_id: str) -> int:
        """Return all of ``seq_id``'s blocks to the pool; returns how
        many. Unknown ids are a no-op (drain paths free defensively)."""
        with self._lock:
            table = self._tables.pop(seq_id, None)
            if table is None:
                return 0
            self._lens.pop(seq_id, None)
            self._reserved.pop(seq_id, None)
            self._free.extend(reversed(table))
            return len(table)

    # -- introspection ---------------------------------------------------

    def block_table(self, seq_id: str) -> List[int]:
        with self._lock:
            return list(self._tables[seq_id])

    def seq_len(self, seq_id: str) -> int:
        with self._lock:
            return self._lens[seq_id]

    def sequences(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    def stats(self) -> Dict[str, int]:
        """Pool occupancy + fragmentation: ``waste_slots`` is the tail
        slack (allocated-but-unfilled token slots), the ONLY internal
        fragmentation paging permits."""
        with self._lock:
            used = self.num_blocks - len(self._free)
            waste = sum(len(t) * self.block_size - self._lens[s]
                        for s, t in self._tables.items())
            reserved_slack = sum(self._reserved[s] - self._lens[s]
                                 for s in self._tables)
            return {
                "blocks_total": self.num_blocks,
                "blocks_used": used,
                "blocks_free": len(self._free),
                "blocks_peak": self._peak_used,
                "sequences": len(self._tables),
                "waste_slots": waste,
                "reserved_slack": reserved_slack,
            }

    def check(self) -> List[str]:
        """Conservation audit (chaos + unit tests): returns violations."""
        errs: List[str] = []
        with self._lock:
            owned: List[int] = []
            for seq, table in self._tables.items():
                owned.extend(table)
                need = -(-self._reserved[seq] // self.block_size)
                if len(table) != need:
                    errs.append(
                        "seq %r: %d block(s) for %d reserved slot(s), "
                        "expected %d"
                        % (seq, len(table), self._reserved[seq], need))
                if not 0 < self._lens[seq] <= self._reserved[seq]:
                    errs.append(
                        "seq %r: live length %d outside its reservation "
                        "%d" % (seq, self._lens[seq], self._reserved[seq]))
            everything = sorted(owned + self._free)
            if everything != list(range(self.num_blocks)):
                errs.append(
                    "block conservation broken: %d owned + %d free != "
                    "%d pool" % (len(owned), len(self._free),
                                 self.num_blocks))
            if len(set(owned)) != len(owned):
                errs.append("a block is owned by two sequences")
        return errs




class PagedKvCache:
    """The tensor half: per-layer K/V pages shaped
    ``[num_blocks + 1, block_size, heads, head_dim]`` on ``device``, plus
    an allocator. ``device=None`` means CUDA, and raises without a card.

    Writes are IN PLACE (``index_put_`` into the page tensors), unlike the
    JAX package's functional ``.at[].set()``: the page tensors keep their
    storage for the cache's life. Single-engine-thread by design (the
    batcher serializes model steps), so only the ALLOCATOR is locked.
    """

    def __init__(self, num_blocks: int, block_size: int, layers: int,
                 heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None) -> None:
        self.allocator = KvBlockAllocator(num_blocks, block_size)
        self.layers = layers
        self.device = resolve_device(device, "PagedKvCache")
        # +1: the LAST page is the decode batch's dummy-row target. The
        # engine pads its batch to a fixed shape; pad rows must scatter
        # their (inert) k/v SOMEWHERE, and it must be a page no live
        # sequence can own or a pad row's write could race a real one.
        self.dummy_page = num_blocks
        shape = (num_blocks + 1, block_size, heads, head_dim)
        self.k_pages = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(layers)]
        self.v_pages = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(layers)]

    def write_prefill(self, seq_id: str, layer: int,
                      k: torch.Tensor, v: torch.Tensor) -> None:
        """Store a prefill's K/V ([S, H, D]) into the sequence's pages:
        token t goes to page ``table[t // bs]``, slot ``t % bs``. (Decode
        writes its one token per row itself, batched, in the engine.)"""
        bs = self.allocator.block_size
        table = self.allocator.block_table(seq_id)
        pos = range(k.shape[0])
        idx = (torch.tensor([table[p // bs] for p in pos], device=self.device),
               torch.tensor([p % bs for p in pos], device=self.device))
        self.k_pages[layer].index_put_(idx, k.to(self.k_pages[layer].dtype))
        self.v_pages[layer].index_put_(idx, v.to(self.v_pages[layer].dtype))
