"""Size-balanced profile partitions.

``balanced_partitions``: contiguous, size-balanced partitions by prefix
sums of per-profile weights — the tensor analogue of the reference's
profile_reader partitioning (src/db/profile_reader.c:44-72 over profile
byte sizes, limits ceiling NUM_THREADS=64).  ``scan --shard`` uses it to
split the DB into share-nothing partitions.  The scan engine's blocks of
one padded width are ``ops/scan_engine.profile_blocks``.
"""

from __future__ import annotations

import numpy as np


def balanced_partitions(weights: np.ndarray, nparts: int) -> list[range]:
    """Split indices 0..N-1 into <= nparts contiguous ranges with roughly
    equal total weight (greedy prefix walk against the ideal boundary).
    ``nparts`` is clamped to NUM_PARTITIONS_MAX, the reference's thread /
    partition ceiling (core/limits.h:8 via profile_reader_setup)."""
    from deciphon_tpu_torch.utils.limits import NUM_PARTITIONS_MAX

    weights = np.asarray(weights, dtype=np.float64)
    n = len(weights)
    nparts = max(1, min(nparts, n, NUM_PARTITIONS_MAX))
    total = float(weights.sum())
    csum = np.concatenate([[0.0], np.cumsum(weights)])
    bounds = [0]
    for p in range(1, nparts):
        target = total * p / nparts
        # first index whose prefix sum reaches the target
        j = int(np.searchsorted(csum, target, side="left"))
        j = max(bounds[-1] + 1, min(j, n - (nparts - p)))
        bounds.append(j)
    bounds.append(n)
    return [range(bounds[i], bounds[i + 1]) for i in range(nparts)]
