"""Reads made from a seed: background DNA and homologs of DB profiles.

Background is uniform ACGT.  A homolog follows a profile's plan-7 path
from a local entry node (match emissions and M/I/D moves drawn from the
profile's own parameters) until it has the amino acids asked for or
leaves the last node; each amino acid is written as one of its codons
drawn at random, substitutions are laid over the DNA at a given rate,
and the coding stretch is embedded in background where it is shorter
than the read.
"""

from __future__ import annotations

import numpy as np

from portbench.lib.dbgen import AMINO, H3Params

NUCLT = np.frombuffer(b"ACGT", np.uint8)
_NCBI = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
# synonymous codons of each amino acid, as [20, 6] codon indices (ACGT
# order) padded by repetition, and their counts
_SYN = [[] for _ in AMINO]
for _i, _aa in enumerate(_NCBI):
    if _aa != "*":
        c = ["TCAG"[_i // 16], "TCAG"[(_i // 4) % 4], "TCAG"[_i % 4]]
        _SYN[AMINO.index(_aa)].append(
            16 * "ACGT".index(c[0]) + 4 * "ACGT".index(c[1]) + "ACGT".index(c[2]))
NSYN = np.array([len(s) for s in _SYN])
SYN = np.array([(s * 6)[:6] for s in _SYN])


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, *stream])


def draw_domains(rng, prm: H3Params, n: int, max_aa):
    """n domains [(profile, amino indices)] from the whole DB: one profile
    from each of n strata by core size, in shuffled order, each with a
    path drawn from its local entry of up to ``max_aa`` residues (one
    number, or one for each of the n places).  Every draw holds the same
    spread of widths, so the work a homolog brings varies little between
    seeds."""
    if n == 0:
        return []
    max_aa = np.broadcast_to(np.asarray(max_aa, np.int64), (n,))
    order = rng.permutation(n)
    out = [None] * n
    for at, s in zip(order, np.array_split(np.argsort(prm.sizes, kind="stable"), n)):
        p = int(rng.choice(s))
        out[at] = (p, domain(rng, prm, p, int(max_aa[at])))
    return out


def background(rng, n: int, length: int) -> np.ndarray:
    """[n, length] uint8 ACGT."""
    return NUCLT[rng.integers(0, 4, (n, length))]


def domain(rng, prm: H3Params, i: int, max_aa: int) -> np.ndarray:
    """Amino indices along profile i's path from a local entry node:
    up to ``max_aa`` residues, ending early where the path leaves the
    last node."""
    match, insert, trans = prm.profile(i)
    K = len(match)
    pm, pi, pt = np.exp(match), np.exp(insert), np.exp(trans)
    k = int(rng.integers(0, max(1, K - max_aa + 1)))
    state, out = "M", []
    while len(out) < max_aa:
        row = pt[k + 1]
        if state == "M":
            out.append(int(np.searchsorted(np.cumsum(pm[k]), rng.random() * pm[k].sum())))
            w = row[[0, 1, 2]]  # MM MI MD
            nxt = "MID"[int(np.searchsorted(np.cumsum(w), rng.random() * w.sum()))]
        elif state == "I":
            out.append(int(np.searchsorted(np.cumsum(pi[k]), rng.random() * pi[k].sum())))
            nxt = "M" if rng.random() < row[3] / (row[3] + row[4]) else "I"
        else:
            nxt = "M" if rng.random() < row[5] / (row[5] + row[6]) else "D"
        if nxt != "I":
            k += 1
            if k >= K:
                break
        state = nxt
    return np.minimum(np.array(out, np.int64), 19)


def back_translate(rng, aminos: np.ndarray) -> np.ndarray:
    """uint8 DNA, each amino acid as a codon drawn among its synonyms."""
    codon = SYN[aminos, (rng.random(len(aminos)) * NSYN[aminos]).astype(int)]
    nt = np.stack([codon // 16, (codon // 4) % 4, codon % 4], 1).reshape(-1)
    return NUCLT[nt]


def substitute(rng, dna: np.ndarray, rate: float) -> np.ndarray:
    """Each nucleotide replaced by another with probability ``rate``."""
    idx = np.searchsorted(NUCLT, dna)  # NUCLT is sorted: A C G T
    hit = rng.random(len(dna)) < rate
    idx[hit] = (idx[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return NUCLT[idx]


def homolog(rng, aminos: np.ndarray, length: int, rate: float) -> str:
    """A read of ``length`` nt carrying the domain ``aminos`` (cut to
    length // 3 residues), in codons drawn from the seed."""
    coding = back_translate(rng, aminos[: length // 3])
    read = background(rng, 1, length)[0]
    at = int(rng.integers(0, length - len(coding) + 1))
    read[at : at + len(coding)] = coding
    return substitute(rng, read, rate).tobytes().decode()


def with_n(rng, read: str) -> str:
    """The read with one position replaced by N."""
    at = int(rng.integers(0, len(read)))
    return read[:at] + "N" + read[at + 1 :]
