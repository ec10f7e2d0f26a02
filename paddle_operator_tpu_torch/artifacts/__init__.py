"""The artifact store of the port, its own copy of
``paddle_operator_tpu/artifacts/``: content-addressed, CRC-pinned
bundles (:mod:`.bundle`), a shared-directory local tier and an
operator-served HTTP tier (:mod:`.store`, :mod:`.server`) with the
compile leases that make a cold fleet build each kernel library once
(:mod:`..compile_cache`), and the checkpoint-state bundles a live
migration MOVEs (:mod:`.state`). Everything degrades to a fallback,
never to a wrong answer, never to a hang.
"""

from .bundle import PoisonedArtifactError, pack, parse
from .store import (
    ArtifactStore, CompileLease, TIERS, enabled, get_store, metrics_text,
    reset_for_tests, stats_block,
)

__all__ = [
    "ArtifactStore", "CompileLease", "PoisonedArtifactError", "TIERS",
    "enabled",
    "get_store", "metrics_text", "pack", "parse", "reset_for_tests",
    "stats_block",
]
