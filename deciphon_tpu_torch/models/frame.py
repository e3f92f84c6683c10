"""Frameshift-tolerant codon ("frame state") emission model.

A frame state intends to emit one codon drawn from a codon distribution
p(x1,x2,x3) but, due to sequencing indel errors with rate epsilon, the
observed fragment Z has length 1..5.  This module replaces the external imm
library's frame-state machinery (imm_frame_state / imm_codon_marg /
imm_nuclt_lprob / imm_frame_cond, used by the reference via
src/model/protein_model.c:247-254 and src/model/protein_profile.c:306-331).

Generative error model (reconstructed from the deciphon model description;
the reference's exact formulas live in the unavailable imm sources, so this
is a from-first-principles derivation kept provably normalized):

  - Draw codon x = (x1,x2,x3) ~ p.
  - Four independent Bernoulli(eps) error events: two *deletion* events and
    two *insertion* events.
  - k fired deletion events remove k distinct codon positions, uniformly
    chosen among the C(3,k) possibilities.
  - k fired insertion events add k background nucleotides (i.i.d. ~ q, the
    state's marginal nucleotide distribution); which observed positions are
    the insertions is uniform over the C(n,k) arrangements of the resulting
    fragment of length n.

  P(len) factors: len3 exact (1-e)^4; len2/len4 leading 2e(1-e)^3;
  len1/len5 e^2(1-e)^2; plus the cross terms (1 del + 1 ins at len 3,
  2 del + 1 ins at len 2, ...).  Sum over all fragments of all lengths is
  exactly 1 (tested in tests/test_frame.py).

Everything is expressed as table lookups so it vectorizes on TPU:

  - codon distribution  -> 5x5x5 log-marginal table M (index 4 = "any",
    i.e. that codon position summed out), flattened to M[125];
  - background nucleotide dist -> q[5] with q[4] = log 1 (sentinel for
    "no inserted nucleotide");
  - every observable fragment (4 + 16 + 64 + 256 + 1024 = 1364 of them)
    scores as a fixed 63-term sum of coef * q[i1] * q[i2] * M[idx]
    products, giving a per-state fragment score table F[1365] (last entry
    is a -inf padding sentinel).
"""

from __future__ import annotations

import itertools

import numpy as np

from deciphon_tpu_torch.models.alphabet import AMINO, GeneticCode, STANDARD_CODE

ANY = -1
NO_INS = -1

# Fragment table layout: offsets of each length block among all fragments of
# lengths 1..5 (base-4 little ordering within a block), plus a -inf sentinel.
FRAG_OFFSET = (0, 0, 4, 20, 84, 340)  # index by length 1..5
NFRAGS = 1364
FRAG_SENTINEL = NFRAGS  # table size NFRAGS + 1, last entry -inf

# IUPAC-extended layout over the 5-symbol alphabet ACGT+N, where symbol
# index 4 (N) is scored as the EXACT marginal over A/C/G/T: every term of
# the fragment probability is multilinear in each observed position's
# nucleotide indicator, so summing a position over the four concrete
# nucleotides equals evaluating it with the codon-marginal "any" pattern
# (index 4 in the base-5 marg table) and the q sentinel q[4] = 1 — the
# same machinery the error model already uses for unobserved positions.
# This reproduces the reference's imm iupac scoring for ambiguous reads
# (src/server/hmm.c:72-73 imm_dna_iupac, consumed at scan.c:229).
FRAG_OFFSET5 = (0, 0, 5, 30, 155, 780)
NFRAGS5 = 3905
FRAG_SENTINEL5 = NFRAGS5


_LAYOUT_CACHE: dict[int, tuple[tuple, int]] = {
    4: (FRAG_OFFSET, FRAG_SENTINEL),
    5: (FRAG_OFFSET5, FRAG_SENTINEL5),
}


def frag_layout(base: int = 4):
    """(offsets, sentinel) for the base-B fragment layout: all fragments
    of lengths 1..5 over B symbols, base-B little ordering per length
    block, one -inf sentinel row at the end.  base > 5 arises from
    reads carrying partially-degenerate IUPAC codes (each distinct code
    in a read batch becomes one extra symbol)."""
    if base not in _LAYOUT_CACHE:
        offsets = [0, 0]
        for length in range(1, 5):
            offsets.append(offsets[-1] + base**length)
        sentinel = offsets[-1] + base**5
        _LAYOUT_CACHE[base] = (tuple(offsets), sentinel)
    return _LAYOUT_CACHE[base]


def frag_index(frag: np.ndarray, base: int = 4) -> int:
    """Index of a fragment (int array of nucleotide indices, len 1..5)."""
    offsets, _ = frag_layout(base)
    n = len(frag)
    idx = 0
    for z in frag:
        idx = idx * base + int(z)
    return offsets[n] + idx


def _build_terms():
    """Static term structure per fragment length.

    Returns dict: length -> (marg_sel [T,3], ins_sel [T,2], class_id [T])
    where marg_sel entries are observed-position indices or ANY, ins_sel are
    observed positions of inserted nucleotides or NO_INS.
    """
    terms = {}

    def add(bucket, pattern, ins, cls):
        bucket.append((tuple(pattern), tuple(ins), cls))

    def codon_patterns_2del(zpos):
        # one surviving codon position k, observed nucleotide at zpos
        return [
            [(zpos, ANY, ANY), (ANY, zpos, ANY), (ANY, ANY, zpos)][k]
            for k in range(3)
        ]

    def codon_patterns_1del(u, v):
        # two surviving codon positions with observed positions (u, v)
        return [(ANY, u, v), (u, ANY, v), (u, v, ANY)]

    # length 1: both deletions fired, no insertion (class L1)
    t1 = []
    for pat in codon_patterns_2del(0):
        add(t1, pat, (NO_INS, NO_INS), "L1")
    terms[1] = t1

    # length 2
    t2 = []
    for pat in codon_patterns_1del(0, 1):  # 1 deletion
        add(t2, pat, (NO_INS, NO_INS), "L2A")
    for ins in (0, 1):  # 2 deletions + 1 insertion
        surv = 1 - ins
        for pat in codon_patterns_2del(surv):
            add(t2, pat, (ins, NO_INS), "L2B")
    terms[2] = t2

    # length 3
    t3 = [((0, 1, 2), (NO_INS, NO_INS), "L3A")]  # exact
    for ins in (0, 1, 2):  # 1 deletion + 1 insertion
        u, v = [p for p in (0, 1, 2) if p != ins]
        for pat in codon_patterns_1del(u, v):
            add(t3, pat, (ins, NO_INS), "L3B")
    for surv in (0, 1, 2):  # 2 deletions + 2 insertions
        i, j = [p for p in (0, 1, 2) if p != surv]
        for pat in codon_patterns_2del(surv):
            add(t3, pat, (i, j), "L3C")
    terms[3] = t3

    # length 4
    t4 = []
    for ins in range(4):  # 1 insertion
        u, v, w = [p for p in range(4) if p != ins]
        add(t4, (u, v, w), (ins, NO_INS), "L4A")
    for i, j in itertools.combinations(range(4), 2):  # 1 del + 2 ins
        u, v = [p for p in range(4) if p not in (i, j)]
        for pat in codon_patterns_1del(u, v):
            add(t4, pat, (i, j), "L4B")
    terms[4] = t4

    # length 5: 2 insertions
    t5 = []
    for i, j in itertools.combinations(range(5), 2):
        u, v, w = [p for p in range(5) if p not in (i, j)]
        add(t5, (u, v, w), (i, j), "L5")
    terms[5] = t5

    out = {}
    for ln, tl in terms.items():
        marg_sel = np.array([t[0] for t in tl], dtype=np.int32)
        ins_sel = np.array([t[1] for t in tl], dtype=np.int32)
        cls = [t[2] for t in tl]
        out[ln] = (marg_sel, ins_sel, cls)
    return out


TERMS = _build_terms()

_CLASS_NAMES = ("L1", "L2A", "L2B", "L3A", "L3B", "L3C", "L4A", "L4B", "L5")


def term_coefs(eps: float) -> dict[str, float]:
    """Per-term probability coefficients (linear space) for each class."""
    e, o = float(eps), 1.0 - float(eps)
    return {
        "L1": e * e * o * o / 3.0,
        "L2A": 2.0 * e * o**3 / 3.0,
        "L2B": 2.0 * e**3 * o / 6.0,
        "L3A": o**4,
        "L3B": 4.0 * e * e * o * o / 9.0,
        "L3C": e**4 / 9.0,
        "L4A": 2.0 * e * o**3 / 4.0,
        "L4B": 2.0 * e**3 * o / 18.0,
        "L5": e * e * o * o / 10.0,
    }


def _enumerate_frags(length: int, base: int = 4) -> np.ndarray:
    """[base^length, length] array of all fragments of the given length."""
    grids = np.meshgrid(*([np.arange(base)] * length), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


# ---------------------------------------------------------------------------
# Distribution tables
# ---------------------------------------------------------------------------


def _any_aggregation_matrix() -> np.ndarray:
    """[125, 64] 0/1 matrix: pattern (base-5, 4=any) -> matching codons."""
    A = np.zeros((125, 64), dtype=np.float64)
    for a in range(5):
        for b in range(5):
            for c in range(5):
                p = a * 25 + b * 5 + c
                for ca in range(4):
                    if a != 4 and a != ca:
                        continue
                    for cb in range(4):
                        if b != 4 and b != cb:
                            continue
                        for cc in range(4):
                            if c != 4 and c != cc:
                                continue
                            A[p, ca * 16 + cb * 4 + cc] = 1.0
    return A


ANY_AGG = _any_aggregation_matrix()

# [64, 4] count of each nucleotide in each codon (for the q marginal).
_CODON_NT_COUNT = np.zeros((64, 4), dtype=np.float64)
for _a in range(4):
    for _b in range(4):
        for _c in range(4):
            _i = _a * 16 + _b * 4 + _c
            _CODON_NT_COUNT[_i, _a] += 1
            _CODON_NT_COUNT[_i, _b] += 1
            _CODON_NT_COUNT[_i, _c] += 1


def codon_lprob_from_amino(
    amino_lprobs: np.ndarray, gc: GeneticCode = STANDARD_CODE
) -> np.ndarray:
    """Lift amino log-probs/log-odds [..., 20] to codon log-probs [..., 64].

    Mass of each amino acid is split evenly over its codons, stop codons get
    zero probability, and the result is normalized.  Mirrors the reference's
    codon_lprob + imm_codon_lprob_normalize (src/model/protein_model.c:361-408).
    """
    amino_lprobs = np.asarray(amino_lprobs, dtype=np.float64)
    batch = amino_lprobs.shape[:-1]
    lp = np.full(batch + (64,), -np.inf, dtype=np.float64)
    sense = gc.aa_of >= 0
    aa = gc.aa_of[sense]
    lp[..., sense] = amino_lprobs[..., aa] - np.log(gc.ncodons_per_aa[aa])
    # normalize
    m = np.max(lp, axis=-1, keepdims=True)
    lse = np.log(np.sum(np.exp(lp - m), axis=-1, keepdims=True)) + m
    return lp - lse


def nuclt_lprob_from_codon(codon_lprobs: np.ndarray) -> np.ndarray:
    """Marginal nucleotide log-probs q[..., 4] from codon log-probs [..., 64].

    q(n) = (1/3) * sum_codon p(codon) * count_n(codon); mirrors nuclt_lprob
    (src/model/protein_model.c:342-359).
    """
    p = np.exp(np.asarray(codon_lprobs, dtype=np.float64))
    q = (p @ _CODON_NT_COUNT) / 3.0
    with np.errstate(divide="ignore"):
        return np.log(q)


def codon_marg(codon_lprobs: np.ndarray) -> np.ndarray:
    """[..., 125] log-marginal table over base-5 patterns (4 = any).

    Replaces imm_codon_marg (used at src/model/protein_model.c:407).
    """
    p = np.exp(np.asarray(codon_lprobs, dtype=np.float64))
    m = p @ ANY_AGG.T
    with np.errstate(divide="ignore"):
        return np.log(m)


def q5_pad(q_log: np.ndarray) -> np.ndarray:
    """Pad q[..., 4] with a log-1 sentinel at index 4 ("no insertion")."""
    q_log = np.asarray(q_log, dtype=np.float64)
    pad = np.zeros(q_log.shape[:-1] + (1,), dtype=q_log.dtype)
    return np.concatenate([q_log, pad], axis=-1)


# ---------------------------------------------------------------------------
# Fragment score tables
# ---------------------------------------------------------------------------


_FRAG_MATRIX_CACHE: dict[tuple[float, int], np.ndarray] = {}


def fragment_matrix(eps: float, base: int = 4) -> np.ndarray:
    """[3125, NFRAGS+1] coefficient matrix C for the matmul form of the
    fragment scores:

        P(Z = frag f) = sum_{i,j,k} qp[i] qp[j] Mp[k] C[i*625+j*125+k, f]

    i.e. ``probs = (qp (x) qp (x) Mp) @ C`` — one GEMM scores every
    fragment for a whole batch of frame states (BLAS on host; MXU-ready
    on device).  The sentinel column stays all-zero -> log 0 = -inf.

    With base=5 the fragment set extends over ACGT+N; an N position
    (value 4) routes to the "any" marg pattern and the q[4]=1 sentinel,
    which IS the exact A/C/G/T marginal (see layout note above)."""
    key = (eps, base)
    if key in _FRAG_MATRIX_CACHE:
        return _FRAG_MATRIX_CACHE[key]
    offsets, sentinel = frag_layout(base)
    coefs = term_coefs(eps)
    C = np.zeros((3125, sentinel + 1), dtype=np.float64)
    for length in range(1, 6):
        frags = _enumerate_frags(length, base)
        fragx = np.concatenate(
            [frags, np.full((frags.shape[0], 1), 4, dtype=frags.dtype)],
            axis=1,
        )
        marg_sel, ins_sel, cls = TERMS[length]
        sel = np.where(marg_sel < 0, length, marg_sel)
        zabc = fragx[:, sel]  # [F, T, 3]
        midx = zabc[..., 0] * 25 + zabc[..., 1] * 5 + zabc[..., 2]  # [F, T]
        isel = np.where(ins_sel < 0, length, ins_sel)
        iidx = fragx[:, isel]  # [F, T, 2]
        coef = np.array([coefs[c] for c in cls])  # [T]
        rows = iidx[..., 0] * 625 + iidx[..., 1] * 125 + midx  # [F, T]
        off = offsets[length]
        for f in range(frags.shape[0]):
            np.add.at(C[:, off + f], rows[f], coef)
    _FRAG_MATRIX_CACHE[key] = C
    return C


def fragment_table(
    marg125_log: np.ndarray, q5_log: np.ndarray, eps: float, base: int = 4
) -> np.ndarray:
    """Score every fragment of length 1..5 for a (batch of) frame state(s).

    Args:
      marg125_log: [..., 125] codon log-marginal table(s).
      q5_log: [..., 5] background nucleotide log-probs, q5_log[..., 4] = 0.
      eps: indel error rate.
      base: 4 (ACGT) or 5 (ACGT+N, exact N marginals; see layout note).

    Returns: [..., 1365] (base 4) or [..., 3906] (base 5) log P(Z) with
    the last entry -inf (padding sentinel).

    One dgemm against ``fragment_matrix`` — ~8x the per-term loop
    (``fragment_table_terms``) on Pfam-scale databases.
    """
    marg125_log = np.asarray(marg125_log, dtype=np.float64)
    q5_log = np.asarray(q5_log, dtype=np.float64)
    batch = marg125_log.shape[:-1]
    Mp = np.exp(marg125_log)
    qp = np.exp(q5_log)
    C = fragment_matrix(eps, base)
    qq = (qp[..., :, None] * qp[..., None, :]).reshape(batch + (25,))
    D = (qq[..., :, None] * Mp[..., None, :]).reshape(batch + (3125,))
    probs = D @ C
    with np.errstate(divide="ignore"):
        out = np.log(probs)
    out[..., frag_layout(base)[1]] = -np.inf
    return out


def fragment_table_terms(
    marg125_log: np.ndarray, q5_log: np.ndarray, eps: float, base: int = 4
) -> np.ndarray:
    """Per-term reference implementation of ``fragment_table`` (kept for
    cross-validation; same semantics, explicit loop over error terms)."""
    marg125_log = np.asarray(marg125_log, dtype=np.float64)
    q5_log = np.asarray(q5_log, dtype=np.float64)
    batch = marg125_log.shape[:-1]
    Mp = np.exp(marg125_log)
    qp = np.exp(q5_log)
    coefs = term_coefs(eps)
    offsets, sentinel = frag_layout(base)

    out = np.zeros(batch + (sentinel + 1,), dtype=np.float64)
    for length in range(1, 6):
        frags = _enumerate_frags(length, base)  # [F, length]
        fragx = np.concatenate(
            [frags, np.full((frags.shape[0], 1), 4, dtype=frags.dtype)], axis=1
        )  # extra col: index `length` holds the q/M sentinel 4
        marg_sel, ins_sel, cls = TERMS[length]
        # marg index per (term, frag)
        sel = np.where(marg_sel < 0, length, marg_sel)  # ANY -> sentinel col
        zabc = fragx[:, sel]  # [F, T, 3]
        midx = zabc[..., 0] * 25 + zabc[..., 1] * 5 + zabc[..., 2]  # [F, T]
        isel = np.where(ins_sel < 0, length, ins_sel)
        iidx = fragx[:, isel]  # [F, T, 2]
        coef = np.array([coefs[c] for c in cls])  # [T]

        contrib = (
            coef
            * qp[..., iidx[..., 0]]
            * qp[..., iidx[..., 1]]
            * Mp[..., midx]
        )  # [..., F, T]
        probs = np.sum(contrib, axis=-1)
        with np.errstate(divide="ignore"):
            off = offsets[length]
            out[..., off : off + frags.shape[0]] = np.log(probs)
    out[..., sentinel] = -np.inf
    return out


# ---------------------------------------------------------------------------
# Extended fragment tables: partially-degenerate IUPAC codes
# ---------------------------------------------------------------------------

# Nucleotide subsets (DNA "ACGT" order) of the IUPAC ambiguity codes.
# The reference scans with imm_dna_iupac (src/server/hmm.c:72-73); a
# degenerate observed symbol scores as the EXACT sum of the fragment
# probability over its nucleotide subset — the multilinearity identity
# behind the base-5 N tables generalizes to any subset.
IUPAC_SUBSETS: dict[str, tuple[int, ...]] = {
    "N": (0, 1, 2, 3), "X": (0, 1, 2, 3),
    "R": (0, 2), "Y": (1, 3), "S": (1, 2), "W": (0, 3),
    "K": (2, 3), "M": (0, 1),
    "B": (1, 2, 3), "D": (0, 2, 3), "H": (0, 1, 3), "V": (0, 1, 2),
}


def _ext_space(codes: tuple[str, ...]):
    """(S, subsets): internal pattern-symbol space for a code tuple.

    Internal symbols: 0..3 concrete nucleotides, 4 = 'any' (doubles as
    the no-insertion q sentinel), 5+j = codes[j]'s subset.  Observed
    fragment symbols map v -> v (v < 4) and 4+j -> 5+j.
    """
    subsets = [IUPAC_SUBSETS[c] for c in codes]
    return 5 + len(codes), subsets


_EXT_AGG_CACHE: dict[tuple, np.ndarray] = {}


def ext_agg(codes: tuple[str, ...]) -> np.ndarray:
    """[S^3, 64] 0/1 matrix: internal pattern -> matching codons (the
    subset-aware generalization of ANY_AGG)."""
    codes = tuple(codes)
    if codes in _EXT_AGG_CACHE:
        return _EXT_AGG_CACHE[codes]
    S, subsets = _ext_space(codes)
    # member[s, n] = 1 if nucleotide n belongs to internal symbol s
    member = np.zeros((S, 4), dtype=np.float64)
    member[np.arange(4), np.arange(4)] = 1.0
    member[4] = 1.0
    for j, sub in enumerate(subsets):
        member[5 + j, list(sub)] = 1.0
    A = np.einsum(
        "ax,by,cz->abcxyz",
        member, member, member,
    ).reshape(S**3, 64)
    _EXT_AGG_CACHE[codes] = A
    return A


_EXT_MATRIX_CACHE: dict[tuple, np.ndarray] = {}


def ext_fragment_matrix(eps: float, codes: tuple[str, ...]) -> np.ndarray:
    """[S^5, sentinel+1] coefficient matrix: the base-(4+D) counterpart
    of ``fragment_matrix`` where D = len(codes) extra observed symbols.

        P(Z = f) = sum_{i,j,k} qe[i] qe[j] Me[k] C[i*S^4 + j*S^3 + k, f]

    with qe the extended q (qe[4] = 1 sentinel, qe[5+j] = subset mass)
    and Me the [S^3] extended codon-marginal table."""
    key = (float(eps), tuple(codes))
    if key in _EXT_MATRIX_CACHE:
        return _EXT_MATRIX_CACHE[key]
    base = 4 + len(codes)
    S, _ = _ext_space(codes)
    offsets, sentinel = frag_layout(base)
    coefs = term_coefs(eps)
    C = np.zeros((S**5, sentinel + 1), dtype=np.float64)
    for length in range(1, 6):
        frags = _enumerate_frags(length, base)
        # observed -> internal symbol mapping; extra col = 'any' sentinel
        obs2int = np.concatenate(
            [np.arange(4), np.arange(5, S)]
        )
        fragi = obs2int[frags]
        fragx = np.concatenate(
            [fragi, np.full((fragi.shape[0], 1), 4, dtype=fragi.dtype)],
            axis=1,
        )
        marg_sel, ins_sel, cls = TERMS[length]
        sel = np.where(marg_sel < 0, length, marg_sel)
        zabc = fragx[:, sel]  # [F, T, 3] internal symbols
        midx = (zabc[..., 0] * S + zabc[..., 1]) * S + zabc[..., 2]
        isel = np.where(ins_sel < 0, length, ins_sel)
        iidx = fragx[:, isel]  # [F, T, 2] internal symbols
        coef = np.array([coefs[c] for c in cls])
        rows = (iidx[..., 0] * S + iidx[..., 1]) * S**3 + midx
        off = offsets[length]
        for f in range(frags.shape[0]):
            np.add.at(C[:, off + f], rows[f], coef)
    _EXT_MATRIX_CACHE[key] = C
    return C


def ext_q(q5_log: np.ndarray, codes: tuple[str, ...]) -> np.ndarray:
    """Extended LINEAR q [..., S]: concrete masses, sentinel 1, subset
    sums per code."""
    S, subsets = _ext_space(codes)
    qp = np.exp(np.asarray(q5_log, dtype=np.float64))[..., :4]
    out = np.ones(qp.shape[:-1] + (S,), dtype=np.float64)
    out[..., :4] = qp
    for j, sub in enumerate(subsets):
        out[..., 5 + j] = qp[..., list(sub)].sum(axis=-1)
    return out


def fragment_table_codes(
    codonp_log: np.ndarray, q5_log: np.ndarray, eps: float,
    codes: tuple[str, ...],
) -> np.ndarray:
    """Fragment score table over base (4 + len(codes)) observed symbols.

    The exact-subset generalization of ``fragment_table``: a fragment
    position holding code c scores as the sum over c's nucleotide
    subset.  ``codonp_log`` is the [..., 64] codon log-prob table (the
    base-5 marg table cannot express subset marginals; the codon table
    can express all of them).
    """
    codes = tuple(codes)
    p = np.exp(np.asarray(codonp_log, dtype=np.float64))
    batch = p.shape[:-1]
    S, _ = _ext_space(codes)
    Me = p @ ext_agg(codes).T  # [..., S^3]
    qe = ext_q(q5_log, codes)  # [..., S]
    C = ext_fragment_matrix(eps, codes)
    qq = (qe[..., :, None] * qe[..., None, :]).reshape(batch + (S * S,))
    D = (qq[..., :, None] * Me[..., None, :]).reshape(batch + (S**5,))
    probs = D @ C
    with np.errstate(divide="ignore"):
        out = np.log(probs)
    out[..., frag_layout(4 + len(codes))[1]] = -np.inf
    return out


def loglik_given_codon(
    frag: np.ndarray, q5_log: np.ndarray, eps: float,
    codes: tuple[str, ...] = ("N",),
) -> np.ndarray:
    """log P(Z | codon) for all 64 codons; [..., 64].

    The conditional counterpart of ``fragment_table`` (replaces
    imm_frame_cond_loglik).  ``frag`` is an int array of length 1..5;
    values >= 4 are ambiguity codes (4+j = ``codes[j]``, default layout:
    4 = N) scored as exact sums over their nucleotide subsets.
    """
    frag = np.asarray(frag)
    length = len(frag)
    q5_log = np.asarray(q5_log, dtype=np.float64)
    qp = np.exp(q5_log)
    coefs = term_coefs(eps)
    marg_sel, ins_sel, cls = TERMS[length]

    def subset_of(v: int) -> tuple[int, ...]:
        return (v,) if v < 4 else IUPAC_SUBSETS[codes[v - 4]]

    def qmass(v):
        if v < 4:
            return qp[..., v]
        return sum(qp[..., b] for b in subset_of(v))

    codons = _enumerate_frags(3)  # [64, 3]

    total = np.zeros(q5_log.shape[:-1] + (64,), dtype=np.float64)
    for t in range(marg_sel.shape[0]):
        coef = coefs[cls[t]]
        # indicator: for each codon position p with pattern obs index s:
        # codon[p] must lie in frag[s]'s subset
        match = np.ones(64, dtype=np.float64)
        for p in range(3):
            s = marg_sel[t, p]
            if s != ANY:
                sub = subset_of(int(frag[s]))
                if len(sub) < 4:
                    match = match * np.isin(codons[:, p], sub)
        qfac = 1.0
        for k in range(2):
            i = ins_sel[t, k]
            if i != NO_INS:
                qfac = qfac * qmass(int(frag[i]))
        total = total + coef * qfac * match
    with np.errstate(divide="ignore"):
        return np.log(total)


def decode_codon(
    frag: np.ndarray, codon_lprobs: np.ndarray, q5_log: np.ndarray,
    eps: float, codes: tuple[str, ...] = ("N",),
) -> tuple[int, int, int]:
    """Most probable intended codon for an observed fragment.

    argmax over codons of p(codon) * p(Z | codon) — the posterior-mode codon
    (replaces imm_frame_cond_decode as used by protein_profile_decode,
    src/model/protein_profile.c:306-331).
    """
    post = np.asarray(codon_lprobs, dtype=np.float64) + loglik_given_codon(
        frag, q5_log, eps, codes
    )
    best = int(np.argmax(post))
    return best // 16, (best // 4) % 4, best % 4
