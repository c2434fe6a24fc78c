"""The serving engine's bucket choice (``repro.data.pipeline``'s
``length_bucket``; the training data pipeline is not ported)."""
from __future__ import annotations

from typing import Tuple


def length_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n (static-shape aggregation ladder)."""
    for b in sorted(buckets):
        if b >= n:
            return b
    return max(buckets)
