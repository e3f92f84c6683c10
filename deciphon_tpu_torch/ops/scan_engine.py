"""Batched scan engine on torch: reads x profile database -> LRT hits.

The counterpart of deciphon_tpu/ops/scan_engine.py, with the same two
passes:

  pass 1 (device): profiles packed into blocks of one padded width
    (db/partition.pack_profile_rows) with their fragment tables built on
    the device; reads split into classes by their set of IUPAC codes
    (scan_engine.py:723-761); every (read, profile) pair of every class
    scored by the CUDA kernel of the scan's semiring (Viterbi, or
    forward under ``algo="forward"``), on base-4 tables for ACGT reads
    and on base-(4+D) tables for a class of D codes (the plain torch
    recurrence on the CPU).  Every launch is queued before one host
    sync per device; then the LRT gate (xmath.h:236-247).
  pass 2 (survivors only): backpointer Viterbi DP + host walk
    (ops/viterbi_trace.py), decoded into match strings by the codec.
    Under forward the hits carry forward logliks and the Viterbi path,
    as in the reference (scan_engine.py:58-63).

``best_hits`` runs pass 1 only and reduces each launch's [rows, B]
scores to each read's best profile on the device, so the host pulls
[rows] vectors and never the [S, P] matrix (scan_engine.py:627-717).

A ``mesh`` (parallel/mesh.py) splits each block's profiles over its
'profiles' axis and each class's reads over 'seqs'
(parallel/sharded_scan.py); ``subset`` scans only the given DB indices
(one share-nothing partition, as ``scan --shard``).

The base-4 tables stay on the device between scans, in a ``Tables``
store that engines of one DB differing only in ScanParams may share.  A
class's extended tables are built per block just before that block's
launches and released right after they are queued, so at most one
extended block is alive at a time (base-6 tables are ~7x the base-4
ones).

The device is explicit: ``device="cuda"`` on a machine without a GPU
raises, and the CPU runs only when named.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from deciphon_tpu_torch.db.format import TensorDB
from deciphon_tpu_torch.db.partition import pack_profile_rows
from deciphon_tpu_torch.models import codec
from deciphon_tpu_torch.models.alphabet import encode_extended
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops import viterbi_trace as vtr
from deciphon_tpu_torch.ops.emissions import fragment_indices
from deciphon_tpu_torch.ops.viterbi_torch import NEG, end_fragment_indices
from deciphon_tpu_torch.parallel.mesh import ScanMesh
from deciphon_tpu_torch.parallel.sharded_scan import (
    Tile,
    merge_best,
    seq_shards,
    shard_tiles,
    tile_best,
)
from deciphon_tpu_torch.utils import trace, xmath


@dataclass(frozen=True)
class ScanParams:
    """sched_scan flags + the scan threshold (reference scan.c:221)."""

    multi_hits: bool = True
    hmmer3_compat: bool = False
    lrt_threshold: float = 10.0
    algo: str = "viterbi"  # "viterbi" | "forward"

    @property
    def semiring(self) -> str:
        if self.algo not in ("viterbi", "forward"):
            raise ValueError(f"unknown algo {self.algo!r}")
        return "logsumexp" if self.algo == "forward" else "max"


@dataclass
class SeqRecord:
    seq_id: int
    name: str
    data: str


@dataclass
class Hit:
    seq_id: int
    seq_idx: int
    profile_idx: int
    accession: str
    alt_loglik: float
    null_loglik: float
    lrt: float
    path: list[tuple[int, int]]
    match: str


@dataclass
class BestHit:
    """Per-read best profile, from the device-side reduction."""

    seq_id: int
    profile_idx: int
    accession: str
    alt_loglik: float
    null_loglik: float
    lrt: float


def resolve_device(device) -> torch.device:
    """The named device; asking for CUDA without a usable GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available()"
                " is False (pass device='cpu' to run on the CPU)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclass
class Block:
    """Profiles (DB indices ``chunk``) sharing one padded width, and
    their base-4 tables once built (one tile, or one per mesh tile)."""

    chunk: np.ndarray
    kpad: int
    tiles: list[Tile] | None = None


class Tables:
    """A DB's blocks and their base-4 tables on one device or mesh.

    Engines of one DB that differ only in ScanParams share one store:
    the flags enter the launch's specials, never the tables."""

    def __init__(self, db: TensorDB, device="cuda",
                 mesh: ScanMesh | None = None, subset=None):
        if mesh is not None:
            for d in mesh.devices:
                resolve_device(d)
            device = mesh.devices[0]
        self.db = db
        self.mesh = mesh
        self.device = resolve_device(device)
        self.subset = None if subset is None else np.asarray(subset, np.int64)
        sizes = (db.core_sizes if self.subset is None
                 else db.core_sizes[self.subset])
        # one width per block: each profile at its LANE-rounded width
        # (the kernel runs one CTA per profile, so there are no sublane
        # rows to fill), widths merged upward while the padding this
        # adds stays under 1% of the nodes
        self.blocks = []
        for kpad, _, _, idxs in pack_profile_rows(
            sizes, lane=vc.LANE, group=1, small_group_kpad=1 << 30,
            seg=False,
        ):
            if self.subset is not None:
                idxs = self.subset[idxs]
            self.blocks.append(Block(idxs, kpad))
        # a prewarm thread and a scan never build one block twice
        self._lock = threading.Lock()

    def _build(self, blk: Block, codes: tuple = ()) -> list[Tile]:
        profiles = [self.db.profile(int(i)) for i in blk.chunk]
        if self.mesh is not None:
            return shard_tiles(profiles, blk.kpad, self.mesh, codes)
        return [Tile(0, 0, np.arange(len(profiles)), vc.CudaBlock.from_profiles(
            profiles, kpad=blk.kpad, device=self.device, codes=codes,
        ))]

    def tiles(self, blk: Block, codes: tuple = ()) -> list[Tile]:
        """The block's tiles: the base-4 ones, built once and kept;
        extended ones (``codes``) built anew on every call and owned by
        the caller."""
        if codes:
            return self._build(blk, codes)
        with self._lock:
            if blk.tiles is None:
                blk.tiles = self._build(blk)
        return blk.tiles

    def prepare(self) -> float:
        """Build every block's base-4 tables; seconds spent."""
        t0 = time.perf_counter()
        for blk in self.blocks:
            self.tiles(blk)
        return time.perf_counter() - t0


class ScanEngine:
    """Scans reads against a TensorDB on one device or a mesh."""

    def __init__(self, db: TensorDB, params: ScanParams = ScanParams(),
                 device="cuda", progress=None, mesh: ScanMesh | None = None,
                 subset=None, tables: Tables | None = None):
        params.semiring  # ValueError on an unknown algo
        self.tables = tables or Tables(db, device, mesh, subset)
        self.db = db
        self.params = params
        self.progress = progress
        self.device = self.tables.device
        self.mesh = self.tables.mesh
        self.blocks = self.tables.blocks
        self._kpad_of = {
            int(gi): blk.kpad for blk in self.blocks for gi in blk.chunk
        }
        # pass-1 (alt, null) of the last scan: [reads, profiles] f32 in
        # input-read and DB-profile order (NEG outside a subset)
        self.last_scores: tuple[np.ndarray, np.ndarray] | None = None
        # host-clock seconds of the last scan's phases (pass 1 ends in
        # the scan's syncs, so it includes the device time)
        self.last_timings: dict = {}

    def packed(self, blk: Block, codes: tuple = ()) -> vc.CudaBlock:
        """An unsharded engine's kernel-layout tables of ``blk``: the
        base-4 ones kept, extended ones (``codes``) built anew."""
        if self.mesh is not None:
            raise ValueError("a mesh engine's tables are per tile")
        (tile,) = self.tables.tiles(blk, codes)
        return tile.blk

    def prepare(self) -> float:
        """Build every block's base-4 tables (the scan's set-up, and the
        counterpart of the JAX engine's warmup); seconds spent."""
        return self.tables.prepare()

    def encode(self, seqs: Sequence[SeqRecord]):
        """(encoded reads, {codes: [read indices]}): each read's symbols
        (ACGT 0..3, its j-th distinct IUPAC code 4+j) and the read
        classes by code set; ValueError on a non-IUPAC letter."""
        encoded, classes = [], {}
        for si, rec in enumerate(seqs):
            enc, codes = encode_extended(rec.data)
            encoded.append(enc)
            classes.setdefault(codes, []).append(si)
        return encoded, classes

    @staticmethod
    def host_batch(encoded: list[np.ndarray], codes: tuple = ()):
        """(order, eidx [S, Lp, 5], seq_len [S]) numpy for one read
        class, rows sorted by length descending (``order`` maps rows to
        positions in ``encoded``); indices over base 4+len(codes)."""
        base = 4 + len(codes)
        order = sorted(range(len(encoded)), key=lambda si: -len(encoded[si]))
        Lp = max(1, max(len(e) for e in encoded))
        eidx = np.stack([
            end_fragment_indices(
                fragment_indices(encoded[si], pad_to=Lp, base=base), base
            )
            for si in order
        ])
        slen = np.array([len(encoded[si]) for si in order], np.int32)
        return np.asarray(order), eidx, slen

    def batch(self, encoded: list[np.ndarray], codes: tuple = ()):
        """``host_batch`` with eidx and seq_len on the engine's device."""
        order, eidx, slen = self.host_batch(encoded, codes)
        return (
            order,
            torch.from_numpy(eidx).to(self.device),
            torch.from_numpy(slen).to(self.device),
        )

    def scan(self, seqs: Sequence[SeqRecord]) -> list[Hit]:
        """Score all (read, profile) pairs; return the LRT-passing hits
        with traceback and match strings, ordered (read, profile)."""
        encoded, classes = self.encode(seqs)
        if not seqs:
            return []
        counters = trace.ScanCounters()
        t0 = time.perf_counter()
        pieces = self._pull(self._queue(encoded, classes, counters))
        S, P = len(encoded), self.db.nprofiles
        alt = np.full((S, P), NEG, np.float32)
        null = np.full((S, P), NEG, np.float32)
        for rows, cols, out in pieces:
            alt[np.ix_(rows, cols)] = out[0]
            null[np.ix_(rows, cols)] = out[1]
        t1 = time.perf_counter()
        self.last_scores = (alt, null)
        p = self.params
        lrt = xmath.lrt(null.astype(np.float64), alt.astype(np.float64))
        ok = np.isfinite(lrt) & (lrt >= p.lrt_threshold)
        ok &= alt > NEG / 2
        self._consume(pieces)
        codes_of = {si: c for c, ids in classes.items() for si in ids}
        survivors = [
            (int(si), int(gi), codes_of[int(si)], float(alt[si, gi]),
             float(null[si, gi]), float(lrt[si, gi]))
            for si, gi in np.argwhere(ok)
        ]
        t2 = time.perf_counter()
        hits = self._traceback(seqs, encoded, survivors)
        self.last_timings = dict(
            pass1=t1 - t0, gate=t2 - t1, pass2=time.perf_counter() - t2,
            survivors=len(survivors),
        )
        counters.report()
        hits.sort(key=lambda h: (h.seq_idx, h.profile_idx))
        return hits

    def best_hits(self, seqs: Sequence[SeqRecord]) -> list[BestHit]:
        """Each read's best profile by LRT, reduced on the device per
        launch; ties keep the first maximum in block order (the JAX
        engine's ``jnp.argmax`` within a block, a strictly larger LRT
        across blocks).  Reads whose every LRT is -inf are left out.  No
        traceback: use ``scan`` for products."""
        encoded, classes = self.encode(seqs)
        if not seqs:
            return []
        counters = trace.ScanCounters()
        pieces = self._pull(
            self._queue(encoded, classes, counters, reduce=True)
        )
        self._consume(pieces)
        counters.report("best_hits")
        return [
            BestHit(
                seq_id=seqs[si].seq_id, profile_idx=gi,
                accession=self.db.profile(gi).accession,
                alt_loglik=float(alt), null_loglik=float(null),
                lrt=float(lrt),
            )
            for si, (gi, lrt, alt, null) in sorted(merge_best(pieces).items())
        ]

    def _consume(self, pieces) -> None:
        # progress advances tile by tile (per block when unsharded)
        if self.progress is not None:
            for rows, cols, _ in pieces:
                self.progress.consume(len(rows) * len(cols))

    def _queue(self, encoded, classes, counters, reduce: bool = False):
        """Queue every launch of pass 1, class by class and block by
        block.  Returns (rows, cols, out) per launch: rows are read
        indices, cols DB indices, and out, on the tile's device, the
        stacked (alt, null) [2, rows, cols] or, with ``reduce``, the
        [4, rows] best of ``sharded_scan.tile_best``."""
        nshards = self.mesh.seqs if self.mesh is not None else 1
        pieces = []
        for codes in sorted(classes):
            ids = classes[codes]
            order, eidx, slen = self.host_batch(
                [encoded[si] for si in ids], codes
            )
            rows = np.asarray(ids)[order]
            batch = _ShardedBatch(eidx, slen, seq_shards(
                np.arange(len(order)), nshards
            ))
            len_sum = int(slen.sum())
            for blk in self.blocks:
                counters.consume(
                    len_sum, int(self.db.core_sizes[blk.chunk].sum())
                )
                pieces.extend(self._queue_block(blk, codes, rows, batch,
                                                reduce))
        return pieces

    def _queue_block(self, blk, codes, rows, batch, reduce):
        """One block's launches, one per tile.  An extended block is
        dropped as soon as they are queued, on return: the caching
        allocator reuses its memory only for later work on the same
        stream, which runs after the queued kernels."""
        p = self.params
        out = []
        for t in self.tables.tiles(blk, codes):
            pos = batch.shards[t.s]
            if not len(pos):
                continue
            eidx, slen = batch.on(t.s, t.blk.fm.device)
            alt, null = vc.scores(
                t.blk, eidx, slen, multi_hits=p.multi_hits,
                hmmer3_compat=p.hmmer3_compat, semiring=p.semiring,
            )
            res = tile_best(alt, null) if reduce else torch.stack([alt, null])
            out.append((rows[pos], blk.chunk[t.cols], res))
        return out

    @staticmethod
    def _pull(pieces):
        """The pieces with host numpy outputs: one transfer, and so one
        sync, per device."""
        by_dev: dict[torch.device, list[int]] = {}
        for i, (_, _, out) in enumerate(pieces):
            by_dev.setdefault(out.device, []).append(i)
        host = [None] * len(pieces)
        for idx in by_dev.values():
            flat = torch.cat(
                [pieces[i][2].reshape(-1) for i in idx]
            ).cpu().numpy()
            off = 0
            for i in idx:
                shape = tuple(pieces[i][2].shape)
                n = int(np.prod(shape))
                host[i] = flat[off : off + n].reshape(shape)
                off += n
        return [(r, c, h) for (r, c, _), h in zip(pieces, host)]

    def _traceback(self, seqs, encoded, survivors) -> list[Hit]:
        """Pass 2, batched by (padded width, read class): one DP per
        group."""
        groups: dict[tuple, list] = {}
        for item in survivors:
            key = (self._kpad_of[item[1]], item[2])
            groups.setdefault(key, []).append(item)
        hits: list[Hit] = []
        for (kpad, codes), items in groups.items():
            profs = [self.db.profile(gi) for _, gi, *_ in items]
            results = vtr.viterbi_alt_batch(
                profs, [encoded[si] for si, *_ in items],
                multi_hits=self.params.multi_hits,
                hmmer3_compat=self.params.hmmer3_compat,
                kpad=kpad, device=self.device, codes=codes,
            )
            for (si, gi, _, alt, null, lrt), prof, res in zip(
                items, profs, results
            ):
                rec = seqs[si]
                hits.append(Hit(
                    seq_id=rec.seq_id, seq_idx=si, profile_idx=gi,
                    accession=prof.accession, alt_loglik=alt,
                    null_loglik=null, lrt=lrt, path=res.path,
                    match=codec.render_match(
                        codec.match_steps(prof, rec.data, res.path)
                    ),
                ))
        return hits


class _ShardedBatch:
    """One read class's host eidx / seq_len, split into read shards and
    uploaded once per (shard, device)."""

    def __init__(self, eidx: np.ndarray, slen: np.ndarray, shards):
        self.eidx, self.slen, self.shards = eidx, slen, shards
        self._dev: dict = {}

    def on(self, s: int, dev: torch.device):
        key = (s, dev)
        if key not in self._dev:
            pos = self.shards[s]
            self._dev[key] = (
                torch.from_numpy(self.eidx[pos]).to(dev),
                torch.from_numpy(self.slen[pos]).to(dev),
            )
        return self._dev[key]
