"""The closed loop that both drivers run, and what it keeps of each unit.

A unit is one call of the timed path: ``ScanEngine.scan`` of a batch of
reads (or of one request's sequence), then ``ProdWriter.add`` for each
hit, as the CLI's flush does.  The loop issues whole units, one after
the other, until ``seconds`` have passed since the first began; units
cycle through the pool that was made before the window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Unit:
    reads: list[str]
    source: np.ndarray  # per read: the profile its homolog came from, or -1
    keep: list[int]  # rows whose pass-1 scores the window keeps
    seqs: list = field(default_factory=list)  # the program's SeqRecords


@dataclass
class Record:
    unit: int  # index into the pool
    start: float  # host clock (perf_counter) at submit
    end: float  # after the last row was added
    nreads: int
    failed: bool
    timings: dict  # the engine's last_timings
    hits: list  # (row, profile, alt, null, path, match) per hit
    rows: dict  # kept row -> (alt [P], null [P]) float32 pass-1 scores


def records_of(engine, writer, unit: Unit, index: int, start: float) -> Record:
    """Run one unit through the timed path."""
    try:
        hits = engine.scan(unit.seqs)
        for h in hits:
            writer.add(h.seq_id, h.accession, h.alt_loglik, h.null_loglik,
                       h.match)
        failed = False
    except Exception:  # noqa: BLE001 - a failed unit is counted, not fatal
        import sys
        import traceback

        print(f"unit {index} failed:\n{traceback.format_exc()}", file=sys.stderr)
        hits, failed = [], True
    end = time.perf_counter()
    rows = {}
    scores = engine.last_scores
    if not failed and (scores is None or len(scores[0]) != len(unit.reads)):
        failed = True  # no pass-1 scores of this unit's reads
    if not failed:
        rows = {j: (scores[0][j].copy(), scores[1][j].copy()) for j in unit.keep}
    return Record(
        unit=index, start=start, end=end, nreads=len(unit.reads),
        failed=failed, timings=dict(engine.last_timings),
        hits=[(h.seq_idx, h.profile_idx, h.alt_loglik, h.null_loglik, h.path,
               h.match) for h in hits],
        rows=rows,
    )


def run_window(engine, writer, units: list[Unit], seconds: float,
               annotate=None) -> list[Record]:
    """Whole units until ``seconds`` have passed since the first began.
    ``annotate(name)`` returns a context manager around each unit (the
    traced run's record_function)."""
    out = []
    t0 = time.perf_counter()
    i = 0
    while True:
        start = time.perf_counter()
        if out and start - t0 >= seconds:
            return out
        u = i % len(units)
        if annotate is None:
            out.append(records_of(engine, writer, units[u], u, start))
        else:
            with annotate("portbench.unit"):
                out.append(records_of(engine, writer, units[u], u, start))
        i += 1
