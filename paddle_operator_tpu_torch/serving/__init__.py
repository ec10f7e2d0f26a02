"""The serving data plane of the port: a continuous-batching engine over
:mod:`..models.gpt` with a paged KV cache.

* :mod:`.batching` — :class:`Request`, :class:`RequestQueue` with counted
  load shedding, :class:`ContinuousBatcher`;
* :mod:`.kv_cache` — the block-table allocator and the paged K/V tensors;
* :mod:`.engine` — :class:`ServingEngine`: prefill, then batched decode
  through the CUDA paged-decode kernel.
"""

from .batching import (  # noqa: F401
    ContinuousBatcher, Request, RequestQueue, SHED_POLICIES,
)
from .engine import ServingEngine  # noqa: F401
from .kv_cache import KvBlockAllocator, KvCacheFull, PagedKvCache  # noqa: F401

__all__ = [
    "ContinuousBatcher", "KvBlockAllocator", "KvCacheFull", "PagedKvCache",
    "Request", "RequestQueue", "SHED_POLICIES", "ServingEngine",
]
