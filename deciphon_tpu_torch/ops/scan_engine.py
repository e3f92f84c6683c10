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
    sync; then the LRT gate (xmath.h:236-247).
  pass 2 (survivors only): backpointer Viterbi DP + host walk
    (ops/viterbi_trace.py), decoded into match strings by the shared
    codec.  Under forward the hits carry forward logliks and the
    Viterbi path, as in the reference (scan_engine.py:58-63).

The base-4 tables stay on the device between scans.  A class's extended
tables are built per block just before that block's launch and released
right after it is queued, so at most one extended block is alive at a
time (base-6 tables are ~7x the base-4 ones).

The device is explicit: ``device="cuda"`` on a machine without a GPU
raises, and the CPU runs only when named.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from deciphon_tpu.db.format import TensorDB
from deciphon_tpu.db.partition import pack_profile_rows
from deciphon_tpu.models import codec
from deciphon_tpu.models.alphabet import encode_extended
from deciphon_tpu.ops.emissions import fragment_indices
from deciphon_tpu.utils import trace, xmath
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops import viterbi_trace as vtr
from deciphon_tpu_torch.ops.viterbi_torch import NEG, end_fragment_indices


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
    """Profiles (DB indices ``chunk``) sharing one padded width."""

    chunk: np.ndarray
    kpad: int
    packed: vc.CudaBlock | None = None


class ScanEngine:
    """Scans reads against a TensorDB on one device."""

    def __init__(self, db: TensorDB, params: ScanParams = ScanParams(),
                 device="cuda", progress=None):
        params.semiring  # ValueError on an unknown algo
        self.db = db
        self.params = params
        self.device = resolve_device(device)
        self.progress = progress
        # one width per block: each profile at its LANE-rounded width
        # (the kernel runs one CTA per profile, so there are no sublane
        # rows to fill), widths merged upward while the padding this
        # adds stays under 1% of the nodes
        self.blocks = [
            Block(idxs, kpad)
            for kpad, _, _, idxs in pack_profile_rows(
                db.core_sizes, lane=vc.LANE, group=1,
                small_group_kpad=1 << 30, seg=False,
            )
        ]
        self._kpad_of = {
            int(gi): blk.kpad for blk in self.blocks for gi in blk.chunk
        }
        # pass-1 (alt, null) of the last scan: [reads, profiles] f32 in
        # input-read and DB-profile order
        self.last_scores: tuple[np.ndarray, np.ndarray] | None = None
        # host-clock seconds of the last scan's phases (pass 1 ends in
        # the scan's one sync, so it includes the device time)
        self.last_timings: dict = {}

    def packed(self, blk: Block, codes: tuple = ()) -> vc.CudaBlock:
        """The block's kernel-layout tables: the base-4 ones, built on
        the device once and kept; extended ones (``codes``) built anew
        on every call and owned by the caller."""
        if codes:
            return vc.CudaBlock.from_profiles(
                [self.db.profile(int(i)) for i in blk.chunk],
                kpad=blk.kpad, device=self.device, codes=codes,
            )
        if blk.packed is None:
            blk.packed = vc.CudaBlock.from_profiles(
                [self.db.profile(int(i)) for i in blk.chunk],
                kpad=blk.kpad, device=self.device,
            )
        return blk.packed

    def prepare(self) -> None:
        """Build every block's base-4 tables (the scan's set-up)."""
        for blk in self.blocks:
            self.packed(blk)

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

    def batch(self, encoded: list[np.ndarray], codes: tuple = ()):
        """(order, eidx [S, Lp, 5], seq_len [S]) on the device for one
        read class, rows sorted by length descending (``order`` maps rows
        to positions in ``encoded``); indices over base 4+len(codes)."""
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
        return (
            np.asarray(order),
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
        alt, null = self._pass1(encoded, classes, counters)
        t1 = time.perf_counter()
        self.last_scores = (alt, null)
        p = self.params
        lrt = xmath.lrt(null.astype(np.float64), alt.astype(np.float64))
        ok = np.isfinite(lrt) & (lrt >= p.lrt_threshold)
        ok &= alt > NEG / 2
        if self.progress is not None:
            self.progress.consume(alt.size)
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

    def _pass1(self, encoded, classes, counters):
        """[reads, profiles] (alt, null) of every class and block; every
        launch is queued before the one host sync."""
        p = self.params
        rows, outs = [], []
        for codes in sorted(classes):
            ids = classes[codes]
            order, eidx, slen = self.batch([encoded[si] for si in ids], codes)
            rows.extend(ids[j] for j in order)
            len_sum = int(slen.sum())
            per_block = []
            for blk in self.blocks:
                counters.consume(
                    len_sum, int(self.db.core_sizes[blk.chunk].sum())
                )
                # an extended block is dropped as soon as its launch is
                # queued: the caching allocator reuses its memory only
                # for later work on the same stream, which runs after
                # the queued kernel
                per_block.append(vc.scores(
                    self.packed(blk, codes), eidx, slen,
                    multi_hits=p.multi_hits, hmmer3_compat=p.hmmer3_compat,
                    semiring=p.semiring,
                ))
            outs.append(torch.stack([
                torch.cat([a for a, _ in per_block], 1),
                torch.cat([n for _, n in per_block], 1),
            ]))
        # the scan's one host sync
        alt, null = torch.cat(outs, 1).cpu().numpy()
        cols = np.concatenate([blk.chunk for blk in self.blocks])
        S, P = len(encoded), self.db.nprofiles
        out_alt = np.empty((S, P), np.float32)
        out_null = np.empty((S, P), np.float32)
        out_alt[np.ix_(rows, cols)] = alt
        out_null[np.ix_(rows, cols)] = null
        return out_alt, out_null

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
