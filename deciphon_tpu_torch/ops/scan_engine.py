"""Batched scan engine on torch: reads x profile database -> LRT hits.

The counterpart of deciphon_tpu/ops/scan_engine.py for the default scan
(Viterbi, ACGT reads), with the same two passes:

  pass 1 (device): profiles packed into blocks of one padded width
    (db/partition.pack_profile_rows) with their fragment tables built on
    the device; every (read, profile) pair scored by the CUDA Viterbi
    kernel (the plain torch recurrence on the CPU).  Every block is
    queued before one host sync; then the LRT gate (xmath.h:236-247).
  pass 2 (survivors only): backpointer DP + host walk
    (ops/viterbi_trace.py), decoded into match strings by the shared
    codec.

The device is explicit: ``device="cuda"`` on a machine without a GPU
raises, and the CPU runs only when named.  Forward scoring and reads with
IUPAC ambiguity codes are later slices of the port (ROADMAP.md).
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
    algo: str = "viterbi"  # "forward" is not ported yet


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
        if params.algo != "viterbi":
            raise NotImplementedError(
                f"algo={params.algo!r} is not ported to deciphon_tpu_torch "
                "yet (ROADMAP.md, queue 1: forward)"
            )
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

    def packed(self, blk: Block) -> vc.CudaBlock:
        """The block's kernel-layout tables, built on the device once."""
        if blk.packed is None:
            blk.packed = vc.CudaBlock.from_profiles(
                [self.db.profile(int(i)) for i in blk.chunk],
                kpad=blk.kpad, device=self.device,
            )
        return blk.packed

    def prepare(self) -> None:
        """Build every block's tables (the scan's set-up)."""
        for blk in self.blocks:
            self.packed(blk)

    def encode(self, seqs: Sequence[SeqRecord]) -> list[np.ndarray]:
        encoded = []
        for rec in seqs:
            enc, codes = encode_extended(rec.data)  # ValueError: non-IUPAC
            if codes:
                raise NotImplementedError(
                    f"read {rec.name!r} holds IUPAC ambiguity codes "
                    f"{''.join(codes)}: not ported to deciphon_tpu_torch "
                    "yet (ROADMAP.md, queue 1: IUPAC)"
                )
            encoded.append(enc)
        return encoded

    def batch(self, encoded: list[np.ndarray]):
        """(order, eidx [S, Lp, 5], seq_len [S]) on the device, reads
        sorted by length descending (``order`` maps rows to inputs)."""
        order = sorted(range(len(encoded)), key=lambda si: -len(encoded[si]))
        Lp = max(1, max(len(e) for e in encoded))
        eidx = np.stack([
            end_fragment_indices(fragment_indices(encoded[si], pad_to=Lp))
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
        encoded = self.encode(seqs)
        if not seqs:
            return []
        counters = trace.ScanCounters()
        t0 = time.perf_counter()
        alt, null = self._pass1(encoded, counters)
        t1 = time.perf_counter()
        self.last_scores = (alt, null)
        p = self.params
        lrt = xmath.lrt(null.astype(np.float64), alt.astype(np.float64))
        ok = np.isfinite(lrt) & (lrt >= p.lrt_threshold)
        ok &= alt > NEG / 2
        if self.progress is not None:
            self.progress.consume(alt.size)
        survivors = [
            (int(si), int(gi), float(alt[si, gi]), float(null[si, gi]),
             float(lrt[si, gi]))
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

    def _pass1(self, encoded, counters):
        p = self.params
        order, eidx, slen = self.batch(encoded)
        len_sum = int(sum(len(e) for e in encoded))
        outs = []
        for blk in self.blocks:
            counters.consume(
                len_sum, int(self.db.core_sizes[blk.chunk].sum())
            )
            outs.append(vc.scores(
                self.packed(blk), eidx, slen,
                multi_hits=p.multi_hits, hmmer3_compat=p.hmmer3_compat,
            ))
        # the scan's one host sync
        alt, null = torch.stack([
            torch.cat([a for a, _ in outs], 1),
            torch.cat([n for _, n in outs], 1),
        ]).cpu().numpy()
        cols = np.concatenate([blk.chunk for blk in self.blocks])
        S, P = len(encoded), self.db.nprofiles
        out_alt = np.empty((S, P), np.float32)
        out_null = np.empty((S, P), np.float32)
        out_alt[np.ix_(order, cols)] = alt
        out_null[np.ix_(order, cols)] = null
        return out_alt, out_null

    def _traceback(self, seqs, encoded, survivors) -> list[Hit]:
        """Pass 2, batched by padded width (one DP per group)."""
        groups: dict[int, list] = {}
        for item in survivors:
            groups.setdefault(self._kpad_of[item[1]], []).append(item)
        hits: list[Hit] = []
        for kpad, items in groups.items():
            profs = [self.db.profile(gi) for _, gi, *_ in items]
            results = vtr.viterbi_alt_batch(
                profs, [encoded[si] for si, *_ in items],
                multi_hits=self.params.multi_hits,
                hmmer3_compat=self.params.hmmer3_compat,
                kpad=kpad, device=self.device,
            )
            for (si, gi, alt, null, lrt), prof, res in zip(
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
