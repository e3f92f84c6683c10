"""Profile-sharded scan tiles over a [seqs, profiles] device mesh.

The counterpart of deciphon_tpu/parallel/pallas_scan.py
(``ShardedPallasBlock`` :42, ``_run_sharded`` :109) together with the
per-read best-hit merge of deciphon_tpu/parallel/sharded_scan.py:22-42.

An engine block's profiles split over the mesh's 'profiles' axis into
contiguous shards (``np.array_split``: shards need not be equal, so no
NEG padding), and each class's reads split over 'seqs'.  Tile (s, p)
holds shard p's tables on device (s, p) and scores read shard s there
with the same kernel launch as an unsharded block, on that device's
current stream.  The kernel computes every (read, profile) cell in its
own CTA, so a tile's cells carry the bits of the unsharded block's.
There is no collective: the engine queues every tile's launch on every
device, syncs once per device, and assembles [S, P] on the host.

Best hits reduce on each tile's device to [rows] vectors; the host
merge keeps the first maximum in block order and, within a block, the
lowest profile index on equal LRT — the (LRT, -index) max of
sharded_scan.py:31-41, which is also what ``jnp.argmax`` over an
unsharded block picks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops.viterbi_torch import NEG
from deciphon_tpu_torch.parallel.mesh import ScanMesh


class Tile(NamedTuple):
    """Read shard ``s`` against the profiles ``cols`` (positions in the
    block's chunk) of profile shard ``p``, with their tables."""

    s: int
    p: int
    cols: np.ndarray
    blk: vc.CudaBlock


def shard_tiles(profiles, kpad: int, mesh: ScanMesh,
                codes: tuple = ()) -> list[Tile]:
    """One Tile per (read shard, non-empty profile shard): the shard's
    tables are built once per profile shard and copied to every other
    tile of its mesh column, so no two tiles share a tensor even where
    the mesh repeats a device."""
    tiles = []
    for p, cols in enumerate(np.array_split(np.arange(len(profiles)),
                                            mesh.profiles)):
        if not len(cols):
            continue
        first = vc.CudaBlock.from_profiles(
            [profiles[i] for i in cols], kpad=kpad,
            device=mesh.device(0, p), codes=codes,
        )
        tiles.append(Tile(0, p, cols, first))
        for s in range(1, mesh.seqs):
            dev = mesh.device(s, p)
            tiles.append(Tile(s, p, cols, vc.CudaBlock(
                *(t.to(dev, copy=True) for t in first)
            )))
    return tiles


def seq_shards(order, nshards: int) -> list[list[int]]:
    """Rows of a length-sorted class dealt round-robin over the read
    shards, so every shard gets reads of every length."""
    return [list(order[s::nshards]) for s in range(nshards)]


def tile_best(alt: torch.Tensor, null: torch.Tensor) -> torch.Tensor:
    """[4, rows] f32 on the tile's device: (argmax column, LRT, alt,
    null) of each row's best profile.  LRT = -2 (null - alt) in f32,
    -inf where alt <= NEG/2 (scan_engine.py:644-650); the first maximum
    wins (``torch.argmax``).  Columns stay below 2^24 (a launch takes at
    most 65535 profiles), so f32 holds them exactly."""
    lrt = torch.where(alt > NEG / 2, -2.0 * (null - alt),
                      torch.full_like(alt, -float("inf")))
    bi = torch.argmax(lrt, dim=1)
    rows = torch.arange(alt.shape[0], device=alt.device)
    return torch.stack([bi.to(torch.float32), lrt[rows, bi], alt[rows, bi],
                        null[rows, bi]])


def merge_best(pieces) -> dict[int, tuple[int, float, float, float]]:
    """{read: (profile, LRT, alt, null)} over host [4, rows] bests, given
    as (rows, cols, best) in block order and, within a block, in
    profile-shard order: a later piece replaces a read's winner only on a
    strictly larger LRT (scan_engine.py:707), so ties keep the earlier
    block and, within a block, the lower profile index."""
    best: dict[int, tuple[int, float, float, float]] = {}
    for rows, cols, (bi, lrt, alt, null) in pieces:
        for i, si in enumerate(rows):
            if not np.isfinite(lrt[i]):
                continue
            cur = best.get(si)
            if cur is None or lrt[i] > cur[1]:
                best[si] = (int(cols[int(bi[i])]), lrt[i], alt[i], null[i])
    return best
