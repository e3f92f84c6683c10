"""Batched scan engine on torch: reads x profile database -> LRT hits.

The counterpart of deciphon_tpu/ops/scan_engine.py, with the same two
passes:

  pass 1 (device): profiles packed into blocks of one padded width
    (``profile_blocks``) with their fragment tables built on
    the device; reads split into classes by their set of IUPAC codes
    (scan_engine.py:723-761); every (read, profile) pair of every class
    scored by the CUDA kernel of the scan's semiring (Viterbi, or
    forward under ``algo="forward"``), on base-4 tables for ACGT reads
    and on base-(4+D) tables for a class of D codes (the plain torch
    recurrence on the CPU).  Every launch is queued before one host
    sync per device; then the LRT gate (xmath.h:236-247).
  pass 2 (survivors only): backpointer Viterbi DP + host walk
    (ops/viterbi_trace.py; the DP is the traceback kernel on a card,
    one launch per chunk of a (width, read class) group, all queued
    before one host wait, and plain torch on the CPU), decoded into
    match strings by the codec.
    Under forward the hits carry forward logliks and the Viterbi path,
    as in the reference (scan_engine.py:58-63).  ``traceback="oracle"``
    runs the f64 numpy oracle per hit instead.

``warmup`` runs pass 1 once per block on a dummy batch of a scan's
shapes (scan_engine.py:492-616), so that the first scan finds the
kernel library, the base-4 tables, each kernel instantiation and the
allocator's buffers ready; the CLI calls it on its first batch and the
daemon while it spools a job's reads.

``best_hits`` runs pass 1 only and reduces each launch's [rows, B]
scores to each read's best profile on the device, so the host pulls
[rows] vectors and never the [S, P] matrix (scan_engine.py:627-717).

A ``mesh`` (parallel/mesh.py) splits each block's profiles over its
'profiles' axis and each class's reads over 'seqs'
(parallel/sharded_scan.py); ``subset`` scans only the given DB indices
(one share-nothing partition, as ``scan --shard``).

The base-4 tables stay on the device between scans, in a ``Tables``
store that engines of one DB differing only in ScanParams may share.  A
class's extended tables are built per profile slice of a block just
before that slice's launches and released right after they are queued,
so at most one slice is alive at a time (base-6 tables are ~7x the
base-4 ones).  A slice is a run of the block's profiles whose tables
fit in EXT_SLICE_BYTES; a block under it is one slice
(``sharded_scan.ext_slices``).  They are synthesized on the device from
per-node inputs that the store uploads once, at the first extended block
it is asked for (``vc.CompactInputs``: codon and background
probabilities, ~276 bytes a node), from the slice's own rows of them, by
one launch of csrc/tables.cu per slice on a card
(ops/tables.block_tables; ``synth_fragment_tables`` on the CPU), and
share views of the transition planes of the block's base-4 tables.  On a
mesh the inputs are uploaded per profile shard, each shard is sliced by
the same rule, and each slice's tables are synthesized once on its
column's first device and copied to the rest (``shard_inputs``,
``extend_tiles``).

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
from deciphon_tpu_torch.models import codec
from deciphon_tpu_torch.models.alphabet import encode_extended
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops import viterbi_ref as vr
from deciphon_tpu_torch.ops import viterbi_trace as vtr
from deciphon_tpu_torch.ops.emissions import fragment_indices
from deciphon_tpu_torch.ops.viterbi_torch import (
    NEG,
    end_fragment_indices,
    resolve_device,
)
from deciphon_tpu_torch.parallel.mesh import ScanMesh
from deciphon_tpu_torch.parallel.sharded_scan import (
    Tile,
    ext_slices,
    extend_tiles,
    merge_best,
    seq_shards,
    shard_inputs,
    shard_tiles,
    tile_best,
)
from deciphon_tpu_torch.utils import trace, xmath

# bytes of extended tables (fm and fin) alive at once on a device: a
# block over it is built and scanned in profile slices
# (sharded_scan.ext_slices), so the extended tables' memory does not grow
# with the DB (the whole Pfam-A release's widest block takes 26.5 GB at
# base 5 and 63.3 GB at base 6)
EXT_SLICE_BYTES = 8 << 30
# padding a merge of whole blocks may add, as a share of all the DB's
# nodes (profile_blocks)
BLOCK_MERGE_SHARE = 0.01


def profile_blocks(core_sizes) -> list[tuple[int, np.ndarray]]:
    """(width, profile indices) of each block of the store, widest first.

    Each profile, in order of core size descending (stable), takes its
    LANE-rounded width ``vc.pad_width``: the kernels run one CTA per
    profile, so a block has no rows to fill.  Each run of equal widths
    is a block.  Then, from the narrowest block up, a block merges into
    the next wider one while the padding that merge adds,
    ``len(block) * (wider - width)``, stays under BLOCK_MERGE_SHARE of
    all the cores; after each merge the walk starts again from the
    narrowest.  Each merge is judged alone, so the merges add up: the
    4,066,991 nodes of portbench's draw of 19,632 profiles fill
    5,510,560 node slots (x1.355), and its width-1600 block, of cores
    545-1600, x2.09."""
    core_sizes = np.asarray(core_sizes)
    order = np.argsort(-core_sizes, kind="stable")
    widths = [vc.pad_width(int(k)) for k in core_sizes[order]]
    cuts = np.flatnonzero(np.diff(widths)) + 1
    blocks = [(widths[run[0]], order[run]) for run in
              np.split(np.arange(len(order)), cuts) if len(run)]
    budget = BLOCK_MERGE_SHARE * float(core_sizes.sum())
    i = len(blocks) - 1
    while i > 0:
        (wide, into), (kpad, idxs) = blocks[i - 1], blocks[i]
        if len(idxs) * (wide - kpad) <= budget:
            blocks[i - 1] = (wide, np.concatenate([into, idxs]))
            del blocks[i]
            i = len(blocks) - 1
        else:
            i -= 1
    return blocks


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


@dataclass
class Block:
    """Profiles (DB indices ``chunk``) sharing one padded width, and
    their base-4 tables once built (one tile, or one per mesh tile)."""

    chunk: np.ndarray
    kpad: int
    tiles: list[Tile] | None = None
    # inputs of extended tables per profile shard (sharded_scan.shard_inputs)
    ext: dict[int, vc.CompactInputs] | None = None


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
        self.blocks = []
        for kpad, idxs in profile_blocks(sizes):
            if self.subset is not None:
                idxs = self.subset[idxs]
            self.blocks.append(Block(idxs, kpad))
        # a prewarm thread and a scan never build one block twice
        self._lock = threading.Lock()

    def _profiles(self, blk: Block) -> list:
        return [self.db.profile(int(i)) for i in blk.chunk]

    def _build(self, blk: Block, codes: tuple = (), part=None) -> list[Tile]:
        """The block's base-4 tiles, or with ``codes`` the extended tiles
        of the profile slice ``part`` (an item of ``slices``)."""
        if codes:
            with trace.span("ext_tables.pack"):
                self._ext_inputs()
            column, pos = part
            with trace.span("ext_tables.synth"):
                return extend_tiles(blk.ext[column[0].p], column, codes, pos)
        profiles = self._profiles(blk)
        if self.mesh is not None:
            return shard_tiles(profiles, blk.kpad, self.mesh)
        return [Tile(0, 0, np.arange(len(profiles)), vc.CudaBlock.from_profiles(
            profiles, kpad=blk.kpad, device=self.device,
        ))]

    def _ext_inputs(self) -> None:
        """Upload every block's inputs of extended tables, per profile
        shard on its tiles' device, once in the store's life (counted as
        ``ext_inputs_built``)."""
        bases = [self.tiles(blk) for blk in self.blocks]
        with self._lock:
            if self.blocks[0].ext is not None:
                return
            trace.count("ext_inputs_built")
            built = [shard_inputs(self._profiles(blk), blk.kpad, tiles)
                     for blk, tiles in zip(self.blocks, bases)]
            for blk, ext in zip(self.blocks, built):
                blk.ext = ext

    def slices(self, blk: Block, codes: tuple):
        """The block's profile slices for read class ``codes``
        (sharded_scan.ext_slices at EXT_SLICE_BYTES)."""
        return ext_slices(self.tiles(blk), blk.kpad, codes, EXT_SLICE_BYTES)

    def tiles(self, blk: Block, codes: tuple = ()):
        """The block's tiles: the base-4 ones, a list built once and
        kept; extended ones (``codes``) yielded one profile slice at a
        time (``slices``), built anew on every call and owned by the
        caller.  A slice is built when the caller asks for its first
        tile, and the generator then holds none of the last slice's: a
        caller that drops each tile before asking for the next keeps at
        most one slice alive."""
        if codes:
            return self._extended(blk, codes)
        with self._lock:
            if blk.tiles is None:
                blk.tiles = self._build(blk)
        return blk.tiles

    def _extended(self, blk: Block, codes: tuple):
        for part in self.slices(blk, codes):
            with trace.span("pass1.ext_tables"):
                tiles = self._build(blk, codes, part)
                trace.count("ext_slices")
                if trace.active():
                    trace.count("ext_tables", len(tiles))
                    trace.count("ext_table_bytes",
                                sum(t.blk.nbytes for t in tiles))
            while tiles:
                yield tiles.pop(0)

    def prepare(self) -> float:
        """Build every block's base-4 tables; seconds spent."""
        t0 = time.perf_counter()
        for blk in self.blocks:
            self.tiles(blk)
        return time.perf_counter() - t0


TRACEBACKS = ("batch", "oracle")


class ScanEngine:
    """Scans reads against a TensorDB on one device or a mesh.

    ``traceback`` picks pass 2: "batch" (``viterbi_trace.trace_scan``,
    the traceback kernel on a card) or "oracle" (the f64 numpy
    ``viterbi_ref.viterbi_alt`` per hit, on the host), as the JAX
    engine's "jax" and "oracle" (scan_engine.py:962-974).  "oracle" is
    a test and reference mode: the CLI and the daemon run "batch"."""

    def __init__(self, db: TensorDB, params: ScanParams = ScanParams(),
                 device="cuda", progress=None, mesh: ScanMesh | None = None,
                 subset=None, tables: Tables | None = None,
                 traceback: str = "batch"):
        params.semiring  # ValueError on an unknown algo
        if traceback not in TRACEBACKS:
            raise ValueError(f"unknown traceback {traceback!r}")
        self.tables = tables or Tables(db, device, mesh, subset)
        self.db = db
        self.params = params
        self.progress = progress
        self.traceback = traceback
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
        # the last scan's spans and counters (utils/trace), empty when it
        # was not recorded
        self.last_spans: list = []
        self.last_counts: dict = {}
        # the last scan's LRT survivors, as trace_groups takes them
        self.last_survivors: list = []
        # overlapping warmups run one after the other
        self._warm_lock = threading.Lock()

    def packed(self, blk: Block, codes: tuple = ()) -> vc.CudaBlock:
        """An unsharded engine's kernel-layout tables of ``blk``: the
        base-4 ones kept, extended ones (``codes``) built anew; a block
        whose extended tables come in several profile slices is refused."""
        if self.mesh is not None:
            raise ValueError("a mesh engine's tables are per tile")
        n = len(self.tables.slices(blk, codes)) if codes else 1
        if n > 1:
            raise ValueError(
                f"the {len(blk.chunk)} profiles of width {blk.kpad} are "
                f"built in {n} slices of at most EXT_SLICE_BYTES for codes "
                f"{codes}: take them from Tables.tiles one slice at a time")
        (tile,) = self.tables.tiles(blk, codes)
        return tile.blk

    def warmup(self, nseqs: int, max_len: int) -> float:
        """Run pass 1 once on a dummy batch of the shapes a scan of
        ``nseqs`` ACGT reads up to ``max_len`` nt gives ``host_batch``,
        the counterpart of the JAX engine's warmup (scan_engine.py:492):
        the kernel library loaded (or built) on a card, every block's
        base-4 tables, and through ``_queue_block`` one launch of the
        semiring's kernel per block (per tile on a mesh) on eidx
        [nseqs, max_len, 5] of symbol 0 with every read 1 nt long, so
        each launch loads its kernel instantiation and allocates the
        scan's output and batch buffers at full size while computing one
        position; then the outputs' pull, one sync per device.  On the
        CPU the same path runs the plain version.  Leaves ``last_*``,
        ``progress`` and pass 2's counters as they were, and its spans
        are not recorded (no scan root); overlapping warmups run one
        after the other.  Seconds spent."""
        with self._warm_lock:
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                from deciphon_tpu_torch.ops import _build

                _build.library()
            self.tables.prepare()
            nshards = self.mesh.seqs if self.mesh is not None else 1
            eidx = np.zeros((nseqs, max(1, max_len), 5), np.int32)
            batch = _ShardedBatch(eidx, np.ones(nseqs, np.int32),
                                  seq_shards(np.arange(nseqs), nshards))
            pieces = []
            for blk in self.blocks:
                pieces.extend(self._queue_block(
                    blk, (), np.arange(nseqs), batch, reduce=False))
            self._pull(pieces)
            return time.perf_counter() - t0

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
        with traceback and match strings, ordered (read, profile).  The
        scan is a root span (utils/trace): recorded, its spans and
        counters are kept as ``last_spans`` and ``last_counts``.  With
        DCP_PROFILE_DIR set the scan runs under a torch.profiler trace
        (utils/trace.device_trace) that shows every span as a range."""
        with trace.device_trace("scan", self.device), \
                trace.root("scan") as rec:
            hits = self._scan(seqs)
        if seqs:
            self.last_spans, self.last_counts = rec.spans, rec.counts
        return hits

    def _scan(self, seqs: Sequence[SeqRecord]) -> list[Hit]:
        te = time.perf_counter()
        with trace.span("encode"):
            encoded, classes = self.encode(seqs)
        if not seqs:
            return []
        t0 = time.perf_counter()
        with trace.span("pass1"):
            pieces = self._pull(self._queue(encoded, classes))
            S, P = len(encoded), self.db.nprofiles
            alt = np.full((S, P), NEG, np.float32)
            null = np.full((S, P), NEG, np.float32)
            for rows, cols, out in pieces:
                alt[np.ix_(rows, cols)] = out[0]
                null[np.ix_(rows, cols)] = out[1]
        t1 = time.perf_counter()
        self.last_scores = (alt, null)
        p = self.params
        with trace.span("gate"):
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
        self.last_survivors = survivors
        with trace.span("pass2"):
            hits = self._traceback(seqs, encoded, survivors)
        self.last_timings = dict(
            encode=t0 - te, pass1=t1 - t0, gate=t2 - t1,
            pass2=time.perf_counter() - t2, survivors=len(survivors),
        )
        hits.sort(key=lambda h: (h.seq_idx, h.profile_idx))
        return hits

    def best_hits(self, seqs: Sequence[SeqRecord]) -> list[BestHit]:
        """Each read's best profile by LRT, reduced on the device per
        launch; ties keep the first maximum in block order (the JAX
        engine's ``jnp.argmax`` within a block, a strictly larger LRT
        across blocks).  Reads whose every LRT is -inf are left out.  No
        traceback: use ``scan`` for products.  Traced as ``scan`` is, under
        a root span ``best_hits``; leaves every ``last_*`` field."""
        with trace.device_trace("best_hits", self.device), \
                trace.root("best_hits"):
            return self._best_hits(seqs)

    def _best_hits(self, seqs: Sequence[SeqRecord]) -> list[BestHit]:
        with trace.span("encode"):
            encoded, classes = self.encode(seqs)
        if not seqs:
            return []
        with trace.span("pass1"):
            pieces = self._pull(self._queue(encoded, classes, reduce=True))
        self._consume(pieces)
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

    def _queue(self, encoded, classes, reduce: bool = False):
        """Queue every launch of pass 1, class by class and block by
        block.  Returns (rows, cols, out) per launch: rows are read
        indices, cols DB indices, and out, on the tile's device, the
        stacked (alt, null) [2, rows, cols] or, with ``reduce``, the
        [4, rows] best of ``sharded_scan.tile_best``."""
        nshards = self.mesh.seqs if self.mesh is not None else 1
        pieces = []
        for codes in sorted(classes):
            ids = classes[codes]
            with trace.span("pass1.eidx"):
                order, eidx, slen = self.host_batch(
                    [encoded[si] for si in ids], codes
                )
            rows = np.asarray(ids)[order]
            batch = _ShardedBatch(eidx, slen, seq_shards(
                np.arange(len(order)), nshards
            ))
            for blk in self.blocks:
                pieces.extend(self._queue_block(blk, codes, rows, batch,
                                                reduce))
        return pieces

    def _queue_block(self, blk, codes, rows, batch, reduce):
        """One block's launches, one per tile.  An extended tile is
        dropped as soon as its launch is queued, before the next profile
        slice is built (``Tables.tiles``): the caching allocator reuses
        its memory only for later work on the same stream, which runs
        after the queued kernels."""
        p = self.params
        out = []
        for t in self.tables.tiles(blk, codes):
            pos = batch.shards[t.s]
            if len(pos):
                with trace.span("pass1.launch"):
                    eidx, slen = batch.on(t.s, t.blk.fm.device)
                    alt, null = vc.scores(
                        t.blk, eidx, slen, multi_hits=p.multi_hits,
                        hmmer3_compat=p.hmmer3_compat, semiring=p.semiring,
                    )
                    res = (tile_best(alt, null) if reduce
                           else torch.stack([alt, null]))
                out.append((rows[pos], blk.chunk[t.cols], res))
            del t  # the loop's next step may build the next slice
        return out

    @staticmethod
    def _pull(pieces):
        """The pieces with host numpy outputs: one transfer, and so one
        sync, per device."""
        with trace.span("pass1.pull"):
            by_dev: dict[torch.device, list[int]] = {}
            for i, (_, _, out) in enumerate(pieces):
                by_dev.setdefault(out.device, []).append(i)
            host = [None] * len(pieces)
            for idx in by_dev.values():
                trace.count("wait.pass1")
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

    def trace_groups(self, survivors) -> dict[tuple, list]:
        """Pass 2's groups of survivors (read index, DB index, codes, alt,
        null, lrt), keyed by (padded width, read class)."""
        groups: dict[tuple, list] = {}
        for item in survivors:
            key = (self._kpad_of[item[1]], item[2])
            groups.setdefault(key, []).append(item)
        return groups

    def _traceback(self, seqs, encoded, survivors) -> list[Hit]:
        """Pass 2, batched by (padded width, read class) and queued as one
        scan (viterbi_trace.trace_scan): on a card one launch of the
        traceback kernel per chunk of TRACE_BATCH hits of a group, every
        chunk queued before the host waits once.  Under the "oracle"
        traceback, the f64 oracle per hit instead.  Every hit's match
        string comes from one batched decode of all their steps
        (``codec.render_matches``)."""
        p = self.params
        groups = list(self.trace_groups(survivors).items())
        profs = [[self.db.profile(gi) for _, gi, *_ in items]
                 for _, items in groups]
        if self.traceback == "oracle":
            results = [
                [vr.viterbi_alt(prof, encoded[si], p.multi_hits,
                                p.hmmer3_compat, codes=codes)
                 for (si, _, codes, *_), prof in zip(items, ps)]
                for (_, items), ps in zip(groups, profs)
            ]
        else:
            results = vtr.trace_scan(
                [(ps, [encoded[si] for si, *_ in items], kpad, codes)
                 for ((kpad, codes), items), ps in zip(groups, profs)],
                multi_hits=p.multi_hits, hmmer3_compat=p.hmmer3_compat,
                device=self.device,
            )
        with trace.span("pass2.codec"):
            rows = [
                (si, gi, alt, null, lrt, prof, res)
                for (_, items), ps, res_g in zip(groups, profs, results)
                for (si, gi, _, alt, null, lrt), prof, res in zip(
                    items, ps, res_g)
            ]
            matches, nsteps = codec.render_matches(
                [(prof, seqs[si].data, res.path)
                 for si, *_, prof, res in rows])
            hits = [
                Hit(seq_id=seqs[si].seq_id, seq_idx=si, profile_idx=gi,
                    accession=prof.accession, alt_loglik=alt,
                    null_loglik=null, lrt=lrt, path=res.path, match=match)
                for (si, gi, alt, null, lrt, prof, res), match in zip(
                    rows, matches)
            ]
        trace.count("hits_decoded", len(hits))
        trace.count("codec_steps", nsteps)
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
