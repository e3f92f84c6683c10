"""Profile-sharded scan tiles over a [seqs, profiles] device mesh.

The counterpart of deciphon_tpu/parallel/pallas_scan.py
(``ShardedPallasBlock`` :42, ``_run_sharded`` :109) together with the
per-read best-hit merge of deciphon_tpu/parallel/sharded_scan.py:22-42.

An engine block's profiles split over the mesh's 'profiles' axis into
contiguous shards of ceil(B / shards) profiles, the shards of the JAX
package's padded axis (pallas_scan._pad_axis0) without its NEG rows: a
tile holds only real profiles, so the last shard may be shorter or
empty.  Each class's reads split over 'seqs'.  Tile (s, p) holds shard
p's tables on device (s, p) and scores read shard s there with the same
kernel launch as an unsharded block, on that device's current stream.
The kernel computes every (read, profile) cell in its own CTA, so a
tile's cells carry the bits of the unsharded block's.
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
from deciphon_tpu_torch.ops.tables import table_bytes
from deciphon_tpu_torch.ops.viterbi_torch import NEG
from deciphon_tpu_torch.parallel.mesh import ScanMesh


class Tile(NamedTuple):
    """Read shard ``s`` against the profiles ``cols`` (positions in the
    block's chunk) of profile shard ``p``, with their tables."""

    s: int
    p: int
    cols: np.ndarray
    blk: vc.CudaBlock


def profile_shards(n: int, nshards: int) -> list[np.ndarray]:
    """Positions 0..n-1 in ``nshards`` contiguous shards of ceil(n /
    nshards), as _pad_axis0 pads the profile axis (the last ones may be
    shorter or empty)."""
    size = -(-n // nshards)
    return [np.arange(p * size, min(n, (p + 1) * size))
            for p in range(nshards)]


def shard_tiles(profiles, kpad: int, mesh: ScanMesh,
                local=None) -> list[Tile]:
    """One Tile per (read shard, non-empty profile shard), or per mesh
    slot in ``local`` (indices into ``mesh.devices``: a process of a
    multi-process mesh builds only its own), with base-4 tables.  A
    shard's tables are built once per profile shard and copied to every
    other tile of its mesh column, so no two tiles share a tensor even
    where the mesh repeats a device."""
    tiles = []
    for p, cols in enumerate(profile_shards(len(profiles), mesh.profiles)):
        if not len(cols):
            continue
        first = None
        for s in range(mesh.seqs):
            if local is not None and s * mesh.profiles + p not in local:
                continue
            dev = mesh.device(s, p)
            if first is None:
                first = blk = vc.CudaBlock.from_profiles(
                    [profiles[i] for i in cols], kpad=kpad, device=dev,
                )
            else:
                blk = vc.CudaBlock(*(t.to(dev, copy=True) for t in first))
            tiles.append(Tile(s, p, cols, blk))
    return tiles


def shard_inputs(profiles, kpad: int, tiles: list[Tile]) -> dict:
    """{profile shard p: the inputs of its extended tables
    (vc.CompactInputs)} on the device of p's first tile in ``tiles``
    (a block's base-4 tiles; one tile of all its profiles unsharded)."""
    out = {}
    for t in tiles:
        if t.p not in out:
            out[t.p] = vc.CompactInputs.from_profiles(
                [profiles[i] for i in t.cols], kpad, t.blk.fm.device)
    return out


def ext_slices(tiles: list[Tile], kpad: int, codes: tuple, budget: int
               ) -> list[tuple[list[Tile], np.ndarray]]:
    """A block's profile slices for the extended tables of read class
    ``codes``, in block order: (the base-4 tiles of one profile shard's
    mesh column, positions in that shard).  Each shard is cut into the
    fewest runs of consecutive profiles whose fm and fin fit in
    ``budget`` bytes, of near-equal length; a profile over the budget
    is a slice alone, and a shard under it one slice."""
    per = max(1, budget // table_bytes(codes, kpad))
    columns: dict[int, list[Tile]] = {}
    for t in tiles:
        columns.setdefault(t.p, []).append(t)
    out = []
    for column in columns.values():
        n = len(column[0].cols)
        out += [(column, pos)
                for pos in np.array_split(np.arange(n), max(1, -(-n // per)))]
    return out


def extend_tiles(inputs: vc.CompactInputs, column: list[Tile], codes: tuple,
                 pos: np.ndarray) -> list[Tile]:
    """The extended tiles of read class ``codes`` of one profile slice
    (``ext_slices``): the profiles ``pos`` of a shard, whose ``inputs``
    (``shard_inputs``) and base-4 ``column`` are given.  Its tables are
    synthesized once from its own rows of the inputs
    (vc.CudaBlock.extended) and copied to every other tile of the
    column; the transition planes, which do not depend on the codes, are
    views of each base tile's own tensors (the tensors themselves for a
    slice of the whole shard)."""
    b0, b1 = int(pos[0]), int(pos[-1]) + 1
    whole = b1 - b0 == inputs.B
    part = inputs if whole else inputs.rows(b0, b1)
    out, first = [], None
    for t in column:
        base = t.blk if whole else t.blk.rows(b0, b1)
        if first is None:
            blk = first = vc.CudaBlock.extended(part, base, codes)
        else:
            dev = t.blk.fm.device
            blk = vc.CudaBlock(first.fm.to(dev, copy=True),
                               first.fin.to(dev, copy=True),
                               base.trans, base.ptrans)
        out.append(Tile(t.s, t.p, t.cols[b0:b1], blk))
    return out


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
