"""Closed loop of read batches, as a scan job runs them.

The daemon claims one job and scans its reads in batches of
DCP_SCAN_BATCH; so does this driver, batch after batch, each the same
make-up: ``batch`` reads of ``read_nt`` nt, of which ``homologous`` carry
a stretch of a DB profile and ``with_n`` carry one N
(``homologous_with_n`` of them homologs), the rest background.  The
homologs of each batch are drawn from the whole DB, one profile from
each of ``homologous`` strata by core size (lib/traffic.draw_domains),
so every batch brings the same spread of widths, with other profiles,
paths, codons, errors and flanks.  A pool
of ``pool`` batches is made from the seed before the window and
cycled.
``reads_per_s`` is every read of every whole batch over the span from
the first batch's submit to the last batch's end.
"""

from __future__ import annotations

import numpy as np

from portbench.lib import traffic as tr
from portbench.lib.loop import Unit


def _batch(rng, prm, mix: dict, n: int, n_hom: int, n_n: int, n_hom_n: int) -> Unit:
    L, rate = mix["read_nt"], mix["substitution"]
    domains = tr.draw_domains(rng, prm, n_hom, L // 3)
    reads = [r.tobytes().decode() for r in tr.background(rng, n, L)]
    source = np.full(n, -1, np.int64)
    rows = rng.permutation(n)
    hom, rest = rows[: len(domains)], rows[len(domains) :]
    for j, (p, aminos) in zip(hom, domains):
        source[j] = p
        reads[j] = tr.homolog(rng, aminos, L, rate)
    nrows = list(hom[:n_hom_n]) + list(rest[: n_n - n_hom_n])
    for j in nrows:
        reads[j] = tr.with_n(rng, reads[j])
    # rows whose pass-1 scores the window keeps for the check: homologs
    # (an N-carrying one first), N-carrying background, plain background
    keep = list(hom[:6]) + list(rest[: min(4, n_n - n_hom_n)])
    keep += list(rest[n_n - n_hom_n :][:6])
    return Unit(reads, source, sorted(int(j) for j in set(keep)))


def generate(mix: dict, prm, seed: int):
    """(pool of units, warm-up units, (batch, max read length))."""
    rng = tr.rng_of(seed, 1)
    n, n_hom = mix["batch"], mix["homologous"]
    n_n, n_hom_n = mix["with_n"], mix["homologous_with_n"]
    pool = [_batch(rng, prm, mix, n, n_hom, n_n, n_hom_n) for _ in range(mix["pool"])]
    # one small batch of the same kinds of reads warms the pass-2 and
    # extended-table paths before the window
    warm = [_batch(rng, prm, mix, 16, min(4, n_hom), min(2, n_n), min(1, n_hom_n))]
    return pool, warm, (n, mix["read_nt"])


def end_to_end(records) -> dict:
    reads = sum(r.nreads for r in records)
    span = records[-1].end - records[0].start
    return {"reads_per_s": (reads / span, "reads/s")}
