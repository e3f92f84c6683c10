"""Whether the timed path's outputs are right: a sample against the reference.

Once the window has closed and the program's state is freed, a sample
drawn from the seed is judged against the plain reference
(portbench/reference/), which works the profiles out again from the
.hmm text that the program pressed:

  - pass 1: the alt and null scores of every sampled read against every
    sampled profile (the sampled reads' homolog sources and hits, random
    profiles and the widest ones), and the gate's decision on each such
    cell: ``pass1_gap`` (largest |program - reference| / (1 + |ref|)) and
    ``gate_flips`` (cells hit by one side only, outside the margin that
    the pass-1 limit leaves around the LRT threshold);
  - pass 2: each sampled hit's state path, scored by the reference:
    ``path_gap`` (the reference's best Viterbi score less the path's
    score, over 1 + |best|; a path that is no path of the model, or does
    not consume the read, reads inf);
  - the codec: each emitting step's codon, by how far its posterior
    lies below the best codon's (``codec_gap``), and ``bad_cells``, the
    hits whose match string does not spell the path (fragment, state,
    the codon's amino acid);
  - ``failed_units``: batches or requests that raised.

``Output`` is what the program (or the control in its place) produced
for the sample; ``judge`` returns each number.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.lib import traffic as tr
from portbench.reference import codec as rc
from portbench.reference import dp
from portbench.reference import model as rm

NUMBERS = ("pass1_gap", "gate_flips", "path_gap", "codec_gap", "bad_cells",
           "failed_units")
KINDS = "MIDX"  # the program's state ids: two top bits of 16
EXT = "RSNBEJCT"


def path_of(ids) -> list[tuple[str, int, int]]:
    """The program's path [(state id, length)] as (kind, node, length)."""
    out = []
    for sid, n in ids:
        kind, low = KINDS[(sid >> 14) & 3], sid & 0x3FFF
        out.append((EXT[low], -1, n) if kind == "X" else (kind, low - 1, n))
    return out


@dataclass
class Sample:
    reads: list[str]  # the sampled reads
    profiles: list[int]  # sampled DB profiles (the grid's columns)
    hits: list[tuple[str, int]]  # (read, profile) of each sampled hit


@dataclass
class Output:
    """The program's answers on a sample."""

    alt: np.ndarray  # [reads, profiles] pass-1 scores
    null: np.ndarray
    hit_sets: list[set]  # per sampled read: the profiles it hit
    hits: list[tuple]  # per sampled hit: (alt, null, path, match string)
    failed_units: int = 0


def _kind(units, key) -> int:
    """0 a homolog, 1 a background read with an IUPAC code, 2 plain."""
    u, row = key
    if units[u].source[row] >= 0:
        return 0
    return 1 if set(units[u].reads[row]) - set("ACGT") else 2


def choose(records, units, sizes: np.ndarray, blocks, check: dict, seed: int):
    """(Sample, the program's Output) from the window's records.  Reads
    among the kept rows: the longest, then as many of each kind present
    (homologs, background with an N, plain background) as the sample
    divides among them, drawn from the seed, topped up from any kind.
    Profiles: the sampled reads' sources and hits, ``check["profiles"]``
    at random, one from each of the program's ``blocks`` (lists of DB
    indices, one kernel width each) and the three widest.  Hits: drawn
    from every hit of the window, the longest read's among them."""
    rng = tr.rng_of(seed, 9)
    kept = {}
    for rec in records:
        for row, scores in rec.rows.items():
            kept.setdefault((rec.unit, row), (rec, scores))
    keys = list(kept)
    rng.shuffle(keys)
    read = lambda k: units[k[0]].reads[k[1]]  # noqa: E731
    n = check["reads"]
    chosen = [max(keys, key=lambda k: len(read(k)))] if keys and n else []
    kinds = sorted({_kind(units, k) for k in keys})
    for j, kind in enumerate(kinds):
        quota = n // len(kinds) + (n % len(kinds) if j == 0 else 0)
        quota -= sum(_kind(units, k) == kind for k in chosen)
        chosen += [k for k in keys if _kind(units, k) == kind and k not in chosen][:max(quota, 0)]
    chosen += [k for k in keys if k not in chosen][: n - len(chosen)]
    hit_sets = []
    for u, row in chosen:
        rec = kept[(u, row)][0]
        hit_sets.append({h[1] for h in rec.hits if h[0] == row})
    profiles = {int(units[u].source[row]) for u, row in chosen} - {-1}
    profiles |= set().union(*hit_sets) if hit_sets else set()
    profiles |= set(rng.choice(len(sizes), min(check["profiles"], len(sizes)),
                               replace=False).tolist())
    profiles |= {int(rng.choice(b)) for b in blocks}
    profiles |= set(np.argsort(sizes)[-3:].tolist())
    profiles = sorted(int(p) for p in profiles)
    alt = np.stack([kept[k][1][0][profiles] for k in chosen]) if chosen else None
    null = np.stack([kept[k][1][1][profiles] for k in chosen]) if chosen else None
    every = [(rec, h) for rec in records for h in rec.hits]
    order = list(rng.permutation(len(every)))
    if every:
        top = max(range(len(every)),
                  key=lambda i: len(units[every[i][0].unit].reads[every[i][1][0]]))
        order = [top] + [i for i in order if i != top]
    picked = [every[i] for i in order[: check["hits"]]]
    sample = Sample([read(k) for k in chosen], profiles,
                    [(units[rec.unit].reads[h[0]], h[1]) for rec, h in picked])
    out = Output(alt, null, hit_sets,
                 [(h[2], h[3], path_of(h[4]), h[5]) for _, h in picked],
                 sum(r.failed for r in records))
    return sample, out


class Reference:
    """Models of DB profiles from the .hmm text, built on first use."""

    def __init__(self, text_of, db_cfg: dict, device):
        self.text_of, self.cfg, self.device = text_of, db_cfg, device
        self._models = {}

    def model(self, p: int) -> rm.Model:
        if p not in self._models:
            self._models[p] = rm.build(rm.parse_h3(self.text_of(p)),
                                       self.cfg["epsilon"], self.cfg["entry_dist"])
        return self._models[p]

    def scores(self, reads: list[str], cells: list[tuple[int, int]],
               semiring: str, scan: dict, dtype=torch.float64, trace=False):
        """Pass-1 (alt, null) of (read index, profile) cells in ``dtype``,
        class by class of the reads' IUPAC codes; with ``trace`` also the
        best paths."""
        enc = [rm.encode(s) for s in reads]
        alt = np.full(len(cells), np.nan)
        null = np.full(len(cells), np.nan)
        paths = [None] * len(cells)
        classes = {}
        for n, (r, p) in enumerate(cells):
            classes.setdefault(enc[r][1], []).append(n)
        for codes, idx in classes.items():
            rids = sorted({cells[n][0] for n in idx})
            pids = sorted({cells[n][1] for n in idx})
            prof = dp.Profiles.build([self.model(p) for p in pids], codes,
                                     self.device, dtype)
            Lp = max(len(enc[r][0]) for r in rids)
            fidx = torch.as_tensor(np.stack([
                rm.fragment_starts(enc[r][0], 4 + len(codes), Lp) for r in rids
            ]), device=self.device)
            lens = np.array([len(enc[r][0]) for r in rids])
            u = np.array([pids.index(cells[n][1]) for n in idx])
            rr = np.array([rids.index(cells[n][0]) for n in idx])
            res = dp.pairs(prof, fidx, lens, u, rr, semiring,
                           scan["multi_hits"], scan["hmmer3_compat"], trace)
            alt[idx], null[idx] = res[0], res[1]
            if trace:
                for j, n in enumerate(idx):
                    paths[n] = res[2][j]
            del prof, fidx
        return (alt, null, paths) if trace else (alt, null)

    def tables64(self, p: int, codes: tuple) -> dict:
        """Profile p's float64 numpy tables over the class of ``codes``."""
        m = self.model(p)
        t = lambda c, q: dp.tables(c, q, m.eps, codes, self.device).cpu().numpy()  # noqa: E731
        return {"fm": t(m.match_codonp, m.match_q),
                "fi": t(m.insert_codonp[None], m.insert_q[None])[0],
                "fn": t(m.null_codonp[None], m.null_q[None])[0]}


def semiring_of(scan: dict) -> str:
    return "lse" if scan.get("algo") == "forward" else "max"


def judge(ref: Reference, sample: Sample, out: Output, scan: dict,
          pass1_limit: float) -> tuple[dict, dict]:
    """(numbers, what was compared)."""
    semi = semiring_of(scan)
    thr = scan["lrt_threshold"]
    nums = {k: 0.0 if k.endswith("gap") else 0 for k in NUMBERS}
    nums["failed_units"] = out.failed_units
    seen = {"reads": len(sample.reads), "profiles": len(sample.profiles),
            "cells": 0, "hits": len(sample.hits)}
    gaps = [0.0]
    if sample.reads:
        cells = [(r, p) for r in range(len(sample.reads)) for p in sample.profiles]
        alt, null = ref.scores(sample.reads, cells, semi, scan)
        alt = alt.reshape(len(sample.reads), -1)
        null = null.reshape(len(sample.reads), -1)
        seen["cells"] = alt.size
        for got, want in ((out.alt, alt), (out.null, null)):
            gaps.append(float(np.max(np.abs(got - want) / (1 + np.abs(want)))))
        lrt = 2.0 * (alt - null)
        margin = 4.0 * pass1_limit * (1 + np.maximum(np.abs(alt), np.abs(null)))
        want_hit = np.isfinite(lrt) & (lrt >= thr)
        got_hit = np.array([[p in hs for p in sample.profiles] for hs in out.hit_sets])
        nums["gate_flips"] = int(((want_hit != got_hit) & (np.abs(lrt - thr) > margin)).sum())
    if sample.hits:
        reads = sorted({s for s, _ in sample.hits})
        cells = [(reads.index(s), p) for s, p in sample.hits]
        alt, null = ref.scores(reads, cells, semi, scan)
        best = alt if semi == "max" else ref.scores(reads, cells, "max", scan)[0]
        got = np.array([h[:2] for h in out.hits], np.float64)
        for g, w in ((got[:, 0], alt), (got[:, 1], null)):
            gaps.append(float(np.max(np.abs(g - w) / (1 + np.abs(w)))))
        path_gap = codec_gap = 0.0
        for (seq, p), (_, _, path, match), b in zip(sample.hits, out.hits, best):
            symbols, codes = rm.encode(seq)
            m = ref.model(p)
            fidx = rm.fragment_starts(symbols, 4 + len(codes), len(symbols))
            s = dp.path_score(m, ref.tables64(p, codes), fidx, len(symbols), path,
                              scan["multi_hits"], scan["hmmer3_compat"])
            path_gap = max(path_gap, (b - s) / (1 + abs(b)) if np.isfinite(s) else np.inf)
            gap, bad = _codec(m, seq, symbols, codes, path, match)
            codec_gap = max(codec_gap, gap)
            nums["bad_cells"] += bad
        nums["path_gap"], nums["codec_gap"] = float(path_gap), float(codec_gap)
    nums["pass1_gap"] = max(gaps)
    return nums, seen


def _codec(m, seq, symbols, codes, path, match: str) -> tuple[float, int]:
    """(largest posterior gap of a decoded codon, 1 if the match string
    does not spell the path else 0)."""
    cells = match.split(";")
    if len(cells) != len(path):
        return 0.0, 1
    gap, pos = 0.0, 0
    for (kind, node, n), cell in zip(path, cells):
        parts = cell.split(",")
        if len(parts) != 4 or parts[0] != seq[pos : pos + n] \
                or parts[1] != rc.state_name(kind, node):
            return gap, 1
        codon, amino = parts[2], parts[3]
        if kind in "NJCMI" and n > 0:
            if len(codon) != 3 or any(c not in rm.NUCLT for c in codon):
                return gap, 1
            c = sum(rm.NUCLT.index(x) * w for x, w in zip(codon, (16, 4, 1)))
            if amino != rm.CODON_AA[c]:
                return gap, 1
            _, post = rc.decode(m, kind, node, symbols[pos : pos + n], codes)
            gap = max(gap, float(post.max() - post[c]))
        elif codon or amino:
            return gap, 1
        pos += n
    return gap, 0


@dataclass
class Control:
    """The reference in the program's place, in a lower precision."""

    ref: Reference
    dtype: torch.dtype
    scan: dict
    hits_max: int
    seed: int

    def output(self, sample: Sample) -> tuple[Sample, Output]:
        """Its answers on the sample's reads and profiles: pass-1 scores
        and the gate in ``dtype``; for hits among those cells, paths
        traced and decoded in ``dtype``."""
        semi = semiring_of(self.scan)
        cells = [(r, p) for r in range(len(sample.reads)) for p in sample.profiles]
        alt, null = self.ref.scores(sample.reads, cells, semi, self.scan, self.dtype)
        alt = alt.reshape(len(sample.reads), -1)
        null = null.reshape(len(sample.reads), -1)
        lrt = 2.0 * (alt - null)
        passed = np.isfinite(lrt) & (lrt >= self.scan["lrt_threshold"])
        hit_sets = [{p for p, ok in zip(sample.profiles, row) if ok} for row in passed]
        found = [(r, p) for r, hs in enumerate(hit_sets) for p in sorted(hs)]
        rng = tr.rng_of(self.seed, 10)
        found = [found[i] for i in rng.permutation(len(found))[: self.hits_max]]
        hits, picked = [], []
        if found:
            _, _, paths = self.ref.scores(sample.reads, found, "max", self.scan,
                                          self.dtype, trace=True)
            for (r, p), path in zip(found, paths):
                seq = sample.reads[r]
                col = sample.profiles.index(p)
                match = ";".join(rc.cells(self.ref.model(p), seq, path, self.dtype))
                hits.append((alt[r, col], null[r, col], path, match))
                picked.append((seq, p))
        return (Sample(sample.reads, sample.profiles, picked),
                Output(alt, null, hit_sets, hits))
