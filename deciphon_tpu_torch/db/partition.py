"""Profile partitioning and padding buckets.

Two layers of work division:

- ``balanced_partitions``: contiguous, size-balanced partitions by prefix
  sums of per-profile weights — the tensor analogue of the reference's
  profile_reader partitioning (src/db/profile_reader.c:44-72 over
  profile byte sizes, limits ceiling NUM_THREADS=64).  Used to shard the
  DB across devices/hosts.
- ``bucket_by_core_size``: groups profiles into padded core-size buckets so
  batched kernels waste little work on padding (the reference has no
  analogue — its DP is per-profile sparse; dense batching makes padding
  economics matter, SURVEY.md §7 hard part (d)).
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


def pad_core_size(k: int, lane: int = 128) -> int:
    """Pad a core size up to a TPU-lane-friendly bucket boundary: small
    power-of-two steps below one lane, lane multiples above."""
    if k <= 8:
        return 8
    if k <= lane:
        p = 8
        while p < k:
            p *= 2
        return p
    return ((k + lane - 1) // lane) * lane


# Segmented-row tiers: (per-profile width W, segments per row nsegs).
# A row packs group*nsegs profiles, each in its own W-lane segment of a
# W*nsegs-lane kernel row (ops/viterbi_pallas.py segmented packing).
# Every W*nsegs product is a 128-multiple <= 768, so segmented rows stay
# fully VMEM-resident (regime A) at the default GROUP=16 width and keep
# the full 32-deep sequence stack (viterbi_pallas.resident_ok/nseq_cap).
SEG_TIERS: tuple[tuple[int, int], ...] = (
    (32, 8),   # K=256
    (64, 8),   # K=512
    (96, 8),   # K=768
    (128, 4),  # K=512
    (160, 4),  # K=640
    (192, 4),  # K=768
    (256, 3),  # K=768
    (320, 2),  # K=640
    (384, 2),  # K=768
)


def _row_candidates(
    kmax: int, lane: int, group: int,
    small_group_kpad: int, small_group: int, seg: bool,
):
    """Row shapes that can hold a profile of core size ``kmax``:
    (kpad, group, nsegs, capacity, lane_cost).  lane_cost = group *
    klanes = the row's compute footprint per position."""
    kpad_u = max(lane, (kmax + lane - 1) // lane * lane)
    g_u = small_group if kpad_u > small_group_kpad else group
    cands = [(kpad_u, g_u, 1, g_u, g_u * kpad_u)]
    if seg:
        for bound, smax in SEG_TIERS:
            if kmax <= bound:
                for s in range(2, smax + 1):
                    if (bound * s) % lane == 0:
                        cands.append(
                            (bound, group, s, group * s,
                             group * s * bound)
                        )
    return cands


def pack_profile_rows(
    core_sizes: np.ndarray,
    lane: int = 128,
    group: int = 16,
    small_group_kpad: int = 768,
    small_group: int = 8,
    seg: bool = False,
    block_penalty: float = 0.01,
) -> list[tuple[int, int, int, np.ndarray]]:
    """Minimum-padding packing for the batched Viterbi kernel, one ROW
    at a time.

    Profiles sorted by core size DESCENDING are packed into sublane
    rows by an exact DP over row shapes: at each position the DP picks
    a row shape (classic one-profile-per-sublane row at the lane-rounded
    width of the row's LARGEST core — narrow ``small_group`` sublanes
    above ``small_group_kpad`` — or a segmented SEG_TIER row packing
    ``group*nsegs`` small cores at W lanes each) and consumes that row's
    slot capacity.  Per-ROW widths are the crucial difference from a
    per-block DP: a block spanning cores 385..640 pads everything to
    640, while per-row packing gives each sorted 16-profile row its own
    width (the round-3 greedy got this right; the round-4 block DP
    regressed it, costing 6% padded work on the bench DB).

    Cost ties prefer UNSEGMENTED rows: segmentation only pays when it
    strictly shrinks lane work, because the per-segment bridge ops lower
    the row's lane rate (measured ~0.5-0.7x, benchmarks/seg_ladder.py —
    a W=256 x2 row costs the same lanes as a 256 row but runs slower).
    ``seg`` defaults False to match the measured-best end-to-end
    configuration (docs/PERFORMANCE.md segmentation A/B); DCP_SEG=1 in
    the engine opts back in.

    Rows sharing (kpad, group, nsegs) merge into one dispatch block;
    ``block_penalty`` (x total core mass) then merges whole blocks
    upward while the extra padding stays under the penalty — each block
    is one kernel compile variant + dispatch, so the penalty trades
    padding efficiency against cold-start compiles and dispatch count.

    This replaces the reference's balanced byte partitions
    (src/db/profile_reader.c:44-72) for the dense-tensor era.  Returns
    a list of (kpad, group, nsegs, profile-index array) blocks where
    kpad is the PER-PROFILE padded width (kernel rows are kpad * nsegs
    lanes wide); every index appears exactly once.
    """
    core_sizes = np.asarray(core_sizes)
    n = len(core_sizes)
    if n == 0:
        return []
    order = np.argsort(-core_sizes, kind="stable")
    sorted_cores = core_sizes[order]

    # exact DP over row shapes, position i = first unpacked profile
    best = np.full(n + 1, np.inf)
    best[n] = 0.0
    choice: list[tuple[int, int, int, int] | None] = [None] * (n + 1)
    for i in range(n - 1, -1, -1):
        kmax = int(sorted_cores[i])
        for kpad, g, s, cap, cost in _row_candidates(
            kmax, lane, group, small_group_kpad, small_group, seg
        ):
            j = min(n, i + cap)
            total = cost + best[j]
            # strict < : candidate list puts the unsegmented row first,
            # so equal-cost segmented rows never displace it
            if total < best[i]:
                best[i] = total
                choice[i] = (kpad, g, s, j)

    # collect rows -> group by shape into dispatch blocks (block order:
    # widest first, matching the sorted profile walk)
    blocks: dict[tuple[int, int, int], list[np.ndarray]] = {}
    shape_order: list[tuple[int, int, int]] = []
    i = 0
    while i < n:
        kpad, g, s, j = choice[i]
        key = (kpad, g, s)
        if key not in blocks:
            blocks[key] = []
            shape_order.append(key)
        blocks[key].append(order[i:j])
        i = j

    out = [
        (kpad, g, s, np.concatenate(blocks[(kpad, g, s)]))
        for (kpad, g, s) in shape_order
    ]

    # merge-upward pass: absorbing a whole block into the nearest wider
    # compatible block costs (width delta + slot padding) lanes; do it
    # while that stays under the penalty budget — fewer blocks = fewer
    # compile variants and dispatches
    budget = block_penalty * float(np.sum(sorted_cores))
    merged = True
    while merged and len(out) > 1:
        merged = False
        for bi in range(len(out) - 1, 0, -1):
            kpad, g, s, idxs = out[bi]
            # nearest wider block whose per-profile width fits ours
            for ti in range(bi - 1, -1, -1):
                tk, tg, ts, tidx = out[ti]
                if tk >= kpad:
                    slots = tg * ts
                    now = (
                        -(-len(tidx) // slots) * slots * tk
                        + -(-len(idxs) // (g * s)) * (g * s) * kpad
                    )
                    joined = (
                        -(-(len(tidx) + len(idxs)) // slots) * slots * tk
                    )
                    if joined - now <= budget:
                        out[ti] = (
                            tk, tg, ts, np.concatenate([tidx, idxs])
                        )
                        del out[bi]
                        merged = True
                    break
            if merged:
                break
    return out


def bucket_by_core_size(
    core_sizes: np.ndarray, lane: int = 128
) -> dict[int, np.ndarray]:
    """Group profile indices by padded core size.

    Returns {kpad: sorted array of profile indices}.
    """
    core_sizes = np.asarray(core_sizes)
    buckets: dict[int, list[int]] = {}
    for i, k in enumerate(core_sizes):
        kp = pad_core_size(int(k), lane)
        buckets.setdefault(kp, []).append(i)
    return {k: np.asarray(v, dtype=np.int64) for k, v in sorted(buckets.items())}
