"""The plain reference's profile model: HMMER3 text -> codon-frame profile.

Worked out from the .hmm text that the program presses too, in float64
numpy, and independent of the program: the standard genetic code, the
Swiss-Prot background, the amino -> codon lift, the background
nucleotide marginals, the match-occupancy entry distribution and the
plan-7 core transitions (the press math of deciphon's protein model, as
src/model/protein_model.c states it), and the frameshift error model's
term structure (four Bernoulli(eps) events: two codon deletions, two
background insertions) from which the fragment tables follow.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

AMINO = "ACDEFGHIKLMNPQRSTVWY"
NUCLT = "ACGT"
# NCBI translation table 1, codons listed in TCAG order
_NCBI_AAS = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
# codon index 16a + 4b + c (ACGT order) -> amino letter, '*' for stop
CODON_AA = ["?"] * 64
for _i, _aa in enumerate(_NCBI_AAS):
    _a, _b, _c = ("TCAG"[_i // 16], "TCAG"[(_i // 4) % 4], "TCAG"[_i % 4])
    CODON_AA[16 * NUCLT.index(_a) + 4 * NUCLT.index(_b) + NUCLT.index(_c)] = _aa
AA_OF_CODON = np.array([AMINO.find(a) for a in CODON_AA])  # -1 for stop
NCODONS = np.bincount(AA_OF_CODON[AA_OF_CODON >= 0], minlength=20)
# each codon's nucleotides, [64, 3]
CODON_NT = np.array([[i // 16, (i // 4) % 4, i % 4] for i in range(64)])

# HMMER3's Swiss-Prot 50.8 background amino frequencies, AMINO order
NULL_AMINO = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062, 0.0695071,
    0.0229198, 0.0590092, 0.0594422, 0.0963728, 0.0237718, 0.0414386,
    0.0482904, 0.0395639, 0.0540978, 0.0683364, 0.0540687, 0.0673417,
    0.0114135, 0.0304133,
])
MM, MI, MD, IM, II, DM, DD = range(7)

# IUPAC codes and their nucleotide subsets
IUPAC = {
    "N": (0, 1, 2, 3), "X": (0, 1, 2, 3), "R": (0, 2), "Y": (1, 3),
    "S": (1, 2), "W": (0, 3), "K": (2, 3), "M": (0, 1), "B": (1, 2, 3),
    "D": (0, 2, 3), "H": (0, 1, 3), "V": (0, 1, 2),
}


@dataclass
class H3:
    """One profile as the .hmm text gives it (natural-log probabilities)."""

    name: str
    accession: str
    match: np.ndarray  # [K, 20], AMINO order
    trans: np.ndarray  # [K + 1, 7]: MM MI MD IM II DM DD; row 0 = BEGIN


def parse_h3(text: str) -> H3:
    """One HMMER3/f profile's text (from its header to '//')."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    head = {}
    i = 1
    while not lines[i].startswith("HMM "):
        key, _, val = lines[i].partition(" ")
        head[key] = val.strip()
        i += 1
    order = [AMINO.index(r) for r in lines[i].split()[1:21]]
    i += 2  # the HMM line and the transition header

    def score(tok: str) -> float:
        return -np.inf if tok == "*" else -float(tok)

    if lines[i].split()[0] == "COMPO":
        i += 1
    i += 1  # the BEGIN node's insert emissions
    K = int(head["LENG"])
    match = np.empty((K, 20))
    trans = [[score(t) for t in lines[i].split()[:7]]]
    i += 1
    for k in range(K):
        toks = lines[i].split()
        if int(toks[0]) != k + 1:
            raise ValueError(f"node {toks[0]} where {k + 1} was due")
        match[k, order] = [score(t) for t in toks[1:21]]
        trans.append([score(t) for t in lines[i + 2].split()[:7]])
        i += 3
    if lines[i].strip() != "//":
        raise ValueError("profile text does not end in '//'")
    return H3(head.get("NAME", ""), head.get("ACC", head.get("NAME", "")),
              match, np.array(trans))


def _lse(a, axis=-1):
    a = np.asarray(a, np.float64)
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return np.squeeze(m, axis) + np.log(np.exp(a - m).sum(axis))


def codon_lprobs(amino_lodds: np.ndarray) -> np.ndarray:
    """[..., 64] codon log-probs: each amino's mass split evenly over its
    codons, stops at 0, normalised."""
    lp = np.full(amino_lodds.shape[:-1] + (64,), -np.inf)
    sense = AA_OF_CODON >= 0
    aa = AA_OF_CODON[sense]
    lp[..., sense] = amino_lodds[..., aa] - np.log(NCODONS[aa])
    return lp - _lse(lp)[..., None]


def nuclt_lprobs(codonp: np.ndarray) -> np.ndarray:
    """[..., 4] log of each nucleotide's share of the codons' positions."""
    p = np.exp(codonp)
    q = np.zeros(p.shape[:-1] + (4,))
    for pos in range(3):
        for n in range(4):
            q[..., n] += p[..., CODON_NT[:, pos] == n].sum(-1)
    with np.errstate(divide="ignore"):
        return np.log(q / 3.0)


@dataclass
class Model:
    """A profile in the reference's form: log-probabilities in float64,
    core transitions indexed by the node they enter (mi, ii by source)."""

    accession: str
    K: int
    eps: float
    match_codonp: np.ndarray  # [K, 64]
    match_q: np.ndarray  # [K, 4]
    insert_codonp: np.ndarray  # [64]
    insert_q: np.ndarray  # [4]
    null_codonp: np.ndarray  # [64]
    null_q: np.ndarray  # [4]
    entry: np.ndarray  # [K]  B -> M_k
    mm_in: np.ndarray  # [K]  M_{k-1} -> M_k
    im_in: np.ndarray
    dm_in: np.ndarray
    md_in: np.ndarray  # [K]  M_{k-1} -> D_k
    dd_in: np.ndarray
    mi: np.ndarray  # [K]  M_k -> I_k
    ii: np.ndarray  # [K]  I_k -> I_k


def _log1mexp(x):
    return np.log1p(-np.exp(x))


def build(h3: H3, eps: float = 0.01, entry_dist: str = "occupancy") -> Model:
    K = h3.match.shape[0]
    t = h3.trans
    null = np.log(NULL_AMINO)
    mcod = codon_lprobs(h3.match - null)
    icod = codon_lprobs(np.zeros(20))
    ncod = codon_lprobs(null)
    if entry_dist == "uniform":
        entry = np.full(K, np.log(2.0 / (K * (K + 1.0))) * K)
    else:
        occ = np.empty(K)
        occ[0] = np.logaddexp(t[0, MI], t[0, MM])
        for k in range(1, K):
            occ[k] = np.logaddexp(
                occ[k - 1] + np.logaddexp(t[k, MM], t[k, MI]),
                _log1mexp(occ[k - 1]) + t[k, DM],
            )
        entry = occ - _lse(occ + np.log(K - np.arange(K)))
    into = {}
    for name, col in (("mm_in", MM), ("im_in", IM), ("dm_in", DM),
                      ("md_in", MD), ("dd_in", DD)):
        a = np.full(K, -np.inf)
        a[1:] = t[1:K, col]
        into[name] = a
    mi = np.full(K, -np.inf)
    ii = np.full(K, -np.inf)
    mi[: K - 1] = t[1:K, MI]
    ii[: K - 1] = t[1:K, II]
    return Model(
        accession=h3.accession, K=K, eps=float(eps),
        match_codonp=mcod, match_q=nuclt_lprobs(mcod),
        insert_codonp=icod, insert_q=nuclt_lprobs(icod),
        null_codonp=ncod, null_q=nuclt_lprobs(ncod),
        entry=entry, mi=mi, ii=ii, **into,
    )


# --- the frameshift error model's terms ---------------------------------
# Per fragment length: (codon pattern [T, 3] of observed positions or ANY,
# inserted positions [T, 2] or NONE, class [T]).  A codon position under
# ANY was deleted; an inserted position is a background nucleotide.
ANY = NONE = -1


def _terms():
    out = {}
    two_del = lambda z: [(z, ANY, ANY), (ANY, z, ANY), (ANY, ANY, z)]  # noqa: E731
    one_del = lambda u, v: [(ANY, u, v), (u, ANY, v), (u, v, ANY)]  # noqa: E731
    t = {1: [], 2: [], 3: [], 4: [], 5: []}
    t[1] += [(p, (NONE, NONE), "L1") for p in two_del(0)]
    t[2] += [(p, (NONE, NONE), "L2A") for p in one_del(0, 1)]
    for ins in (0, 1):
        t[2] += [(p, (ins, NONE), "L2B") for p in two_del(1 - ins)]
    t[3].append(((0, 1, 2), (NONE, NONE), "L3A"))
    for ins in (0, 1, 2):
        u, v = [p for p in (0, 1, 2) if p != ins]
        t[3] += [(p, (ins, NONE), "L3B") for p in one_del(u, v)]
    for surv in (0, 1, 2):
        i, j = [p for p in (0, 1, 2) if p != surv]
        t[3] += [(p, (i, j), "L3C") for p in two_del(surv)]
    for ins in range(4):
        t[4].append((tuple(p for p in range(4) if p != ins), (ins, NONE),
                     "L4A"))
    for i, j in itertools.combinations(range(4), 2):
        u, v = [p for p in range(4) if p not in (i, j)]
        t[4] += [(p, (i, j), "L4B") for p in one_del(u, v)]
    for i, j in itertools.combinations(range(5), 2):
        t[5].append((tuple(p for p in range(5) if p not in (i, j)), (i, j),
                     "L5"))
    for n, rows in t.items():
        out[n] = (np.array([r[0] for r in rows]), np.array([r[1] for r in rows]),
                  [r[2] for r in rows])
    return out


TERMS = _terms()


def term_coefs(eps: float) -> dict[str, float]:
    """Probability of each class of error events (linear), per term."""
    e, o = float(eps), 1.0 - float(eps)
    return {
        "L1": e * e * o * o / 3.0, "L2A": 2.0 * e * o**3 / 3.0,
        "L2B": 2.0 * e**3 * o / 6.0, "L3A": o**4,
        "L3B": 4.0 * e * e * o * o / 9.0, "L3C": e**4 / 9.0,
        "L4A": 2.0 * e * o**3 / 4.0, "L4B": 2.0 * e**3 * o / 18.0,
        "L5": e * e * o * o / 10.0,
    }


def layout(base: int):
    """(offset of each fragment length 1..5, sentinel row) over ``base``
    observed symbols; fragments read as base-``base`` numbers, first
    symbol most significant; the sentinel row scores -inf."""
    offsets = [0, 0]
    for n in range(1, 5):
        offsets.append(offsets[-1] + base**n)
    return offsets, offsets[-1] + base**5


def members(codes: tuple) -> np.ndarray:
    """[5 + D, 4] 0/1: internal symbol -> nucleotides it stands for:
    0..3 the nucleotides, 4 any (also 'no insertion'), 5 + j codes[j]."""
    m = np.zeros((5 + len(codes), 4))
    m[np.arange(4), np.arange(4)] = 1.0
    m[4] = 1.0
    for j, c in enumerate(codes):
        m[5 + j, list(IUPAC[c])] = 1.0
    return m


def encode(seq: str) -> tuple[np.ndarray, tuple]:
    """(symbols, codes): ACGT -> 0..3, the j-th distinct IUPAC code of the
    read (sorted, X as N) -> 4 + j."""
    s = seq.upper().replace("U", "T").replace("X", "N")
    codes = tuple(sorted({ch for ch in s if ch not in NUCLT}))
    for ch in codes:
        if ch not in IUPAC:
            raise ValueError(f"{ch!r} is not an IUPAC nucleotide code")
    sym = {ch: i for i, ch in enumerate(NUCLT)}
    sym.update({ch: 4 + j for j, ch in enumerate(codes)})
    return np.array([sym[ch] for ch in s], np.int64), codes


def fragment_starts(symbols: np.ndarray, base: int, pad_to: int) -> np.ndarray:
    """[pad_to, 5]: row i, column l - 1 is the table row of the fragment
    symbols[i : i + l], or the sentinel where it runs past the end."""
    offsets, sentinel = layout(base)
    L = len(symbols)
    out = np.full((pad_to, 5), sentinel, np.int64)
    for n in range(1, 6):
        if L - n + 1 <= 0:
            continue
        code = np.zeros(L - n + 1, np.int64)
        for d in range(n):
            code = code * base + symbols[d : L - n + 1 + d]
        out[: L - n + 1, n - 1] = offsets[n] + code
    return out
