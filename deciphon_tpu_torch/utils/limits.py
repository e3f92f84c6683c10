"""Global envelope limits, mirroring the reference's
include/deciphon/core/limits.h:4-13.

The reference enforces these mostly by construction (fixed-size arrays);
the tensor rebuild checks them explicitly and raises EINVAL so oversized
inputs fail with a clear message instead of a shape error deep in XLA.
"""

from __future__ import annotations

# Max profiles per database (limits.h:7 MAX_NPROFILES = 1 << 20).
MAX_NPROFILES = 1 << 20

# Max profile core size in nodes (limits.h:11 PROTEIN_MODEL_CORE_SIZE_MAX).
CORE_SIZE_MAX = 4096

# Max scan partitions — the reference's OpenMP thread / DB-partition
# ceiling (limits.h:8 NUM_THREADS = 64).  The tensor analogue bounds
# host-side partition fan-out (db/partition.balanced_partitions).
NUM_PARTITIONS_MAX = 64
