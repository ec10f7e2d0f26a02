"""Seeded numpy inputs shared by the port's tests and ``chip_smoke.py``.

Inputs are made with numpy so that the JAX reference and the port see the
same numbers; each case is a dict of numpy arrays plus its shape fields.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: the paged-decode cases: the ragged, non-contiguous case of the JAX
#: package's serving tests; a bs=16, head_dim=128 case; and the full-width
#: decode shape of GPT-2 small under the engine (B=8, H=12, D=64, bs=16,
#: T=64 pages of a 1024-token max_seq)
PAGED_CASES = ("ragged", "bs16_d128", "full_width")


def paged_decode_case(name: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """q [B,H,D], k_pages/v_pages [P,bs,H,D] fp32, tables [B,T] int32,
    lens [B] int32 (every len >= 1)."""
    rng = np.random.default_rng(seed)
    if name == "ragged":
        b, h, d, bs, pages = 3, 2, 64, 8, 16
        tables = np.asarray([[1, 5, 9, 13], [2, 6, 10, 14], [3, 7, 11, 0]])
        lens = np.asarray([5, 16, 23])
    elif name == "bs16_d128":
        b, h, d, bs, pages, t = 4, 3, 128, 16, 24, 5
        tables = rng.permutation(pages)[:b * t].reshape(b, t)
        lens = np.asarray([1, 17, 40, t * bs])
    elif name == "full_width":
        b, h, d, bs, t = 8, 12, 64, 16, 64
        pages = b * t + 1
        tables = rng.permutation(pages)[:b * t].reshape(b, t)
        lens = rng.integers(1, t * bs + 1, size=b)
        lens[0] = t * bs                       # one sequence fills its table
    else:
        raise ValueError("unknown paged-decode case %r" % name)
    return {
        "q": rng.standard_normal((b, h, d), dtype=np.float32),
        "k_pages": rng.standard_normal((pages, bs, h, d), dtype=np.float32),
        "v_pages": rng.standard_normal((pages, bs, h, d), dtype=np.float32),
        "tables": np.asarray(tables, dtype=np.int32),
        "lens": np.asarray(lens, dtype=np.int32),
    }
