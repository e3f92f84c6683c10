"""Viterbi path decoding into codons / amino acids / match strings.

Replaces protein_codec (src/model/protein_codec.c:6-24) and the match
formatter protein_match_write_func (src/server/protein_match.c:21-56):
walking a path, every non-mute step's consumed fragment is decoded to its
most probable intended codon (via the owning state's distribution,
protein_profile_decode, src/model/protein_profile.c:306-331) and the
codon's amino acid.

``match_steps`` decodes one step at a time with ``frame.decode_codon``;
``render_matches`` decodes every step of many hits in one
``decode_steps`` call, with the same float operations in the same order,
so its strings equal ``render_match(match_steps(...))`` character for
character.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from deciphon_tpu_torch.models import frame
from deciphon_tpu_torch.models import state as st
from deciphon_tpu_torch.models.alphabet import (
    DNA, STANDARD_CODE, encode_extended,
)
from deciphon_tpu_torch.models.profile import ProteinProfile


@dataclass
class MatchStep:
    frag: str
    state: str
    codon: str
    amino: str

    def render(self) -> str:
        return f"{self.frag},{self.state},{self.codon},{self.amino}"


def _decode_dists(prof: ProteinProfile, state_id: int):
    if st.is_insert(state_id):
        return prof.insert_codonp, prof.insert_q
    if st.is_match(state_id):
        k = st.node_idx(state_id)
        return prof.match_codonp[k], prof.match_q[k]
    return prof.null_codonp, prof.null_q  # R, N, J, C


def decode_codons(
    prof: ProteinProfile, seq_idx: np.ndarray, path: list[tuple[int, int]],
    codes: tuple[str, ...] = ("N",),
) -> list[tuple[int, int, int]]:
    """Codon stream of a path, skipping mute states (protein_codec_next).
    ``codes`` names the ambiguity symbols 4+j of ``seq_idx``."""
    out = []
    pos = 0
    for state_id, seqlen in path:
        if seqlen > 0 and not st.is_mute(state_id):
            codonp, q = _decode_dists(prof, state_id)
            frag = seq_idx[pos : pos + seqlen]
            out.append(
                frame.decode_codon(frag, codonp, q, prof.cfg.epsilon, codes)
            )
        pos += seqlen
    return out


def match_steps(
    prof: ProteinProfile, seq: str, path: list[tuple[int, int]]
) -> list[MatchStep]:
    """Per-step match cells 'frag,state,codon,amino' (mute states keep the
    codon/amino fields empty), e.g. 'CG,M1,CGA,K'."""
    seq_idx, codes = encode_extended(seq)
    out = []
    pos = 0
    for state_id, seqlen in path:
        fragstr = seq[pos : pos + seqlen]
        codon_str = ""
        amino = ""
        if not st.is_mute(state_id) and seqlen > 0:
            codonp, q = _decode_dists(prof, state_id)
            a, b, c = frame.decode_codon(
                seq_idx[pos : pos + seqlen], codonp, q, prof.cfg.epsilon,
                codes,
            )
            codon_str = STANDARD_CODE.codon_str(a, b, c)
            amino = STANDARD_CODE.decode(a, b, c)
        out.append(
            MatchStep(fragstr, st.name(state_id), codon_str, amino)
        )
        pos += seqlen
    return out


def render_match(steps: list[MatchStep]) -> str:
    return ";".join(s.render() for s in steps)


def _symbol_tables():
    """Global symbols of decode_steps: 0..3 the nucleotides, 4 + j the
    code _LETTERS[j].  (subset [S, 4], member [S, 4]): each symbol's
    nucleotides in IUPAC_SUBSETS order (-1 padded), as
    frame.loglik_given_codon's q mass sums them, and as a mask."""
    subset = np.full((4 + len(_LETTERS), 4), -1, dtype=np.int64)
    subset[np.arange(4), 0] = np.arange(4)
    for j, c in enumerate(_LETTERS):
        sub = frame.IUPAC_SUBSETS[c]
        subset[4 + j, : len(sub)] = sub
    member = np.zeros(subset.shape, dtype=bool)
    for g, sub in enumerate(subset):
        member[g, sub[sub >= 0]] = True
    return subset, member


_LETTERS = tuple(frame.IUPAC_SUBSETS)
_SUBSET, _MEMBER = _symbol_tables()
_CODONS = frame._enumerate_frags(3)  # [64, 3]


def decode_steps(
    frags: list[np.ndarray], codonp: np.ndarray, q: np.ndarray,
    eps: np.ndarray, codes: list[tuple[str, ...]],
) -> np.ndarray:
    """``frame.decode_codon`` of n steps at once: [n] codon indices
    16a + 4b + c.

    Step i decodes fragment ``frags[i]`` (1..5 symbols, 4 + j standing
    for ``codes[i][j]``) under codon log-probs ``codonp[i]`` [64],
    background ``q[i]`` [5] and error rate ``eps[i]``.  Steps of one
    fragment length share their terms (``frame.TERMS``); each term's
    codon indicator, insert factor and sum are the scalar version's
    IEEE operations in its order, so every codon, and every tie that
    the first index breaks, comes out the same."""
    n = len(frags)
    out = np.zeros(n, dtype=np.int64)
    if n == 0:
        return out
    lens = np.fromiter(map(len, frags), dtype=np.int64, count=n)
    # every step's symbols as global symbols, [n, 5]
    set_id: dict[tuple[str, ...], int] = {}
    sid = np.fromiter((set_id.setdefault(tuple(c), len(set_id))
                       for c in codes), dtype=np.int64, count=n)
    remap = np.zeros((len(set_id), 4 + len(_LETTERS)), dtype=np.int64)
    remap[:, :4] = np.arange(4)
    for cs, i in set_id.items():
        remap[i, 4 : 4 + len(cs)] = [4 + _LETTERS.index(c) for c in cs]
    start = np.cumsum(lens) - lens
    flat = np.arange(int(lens.sum()))
    row = np.repeat(np.arange(n), lens)
    sym = np.zeros((n, 5), dtype=np.int64)
    sym[row, flat - start[row]] = remap[sid[row], np.concatenate(frags)]
    # the terms' coefficients by error rate
    eps = np.asarray(eps, dtype=np.float64)
    uniq, eps_id = np.unique(eps, return_inverse=True)
    coefs = [frame.term_coefs(float(e)) for e in uniq]
    codonp = np.asarray(codonp, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    for length in range(1, 6):
        rows = np.flatnonzero(lens == length)
        if not len(rows):
            continue
        marg_sel, ins_sel, cls = frame.TERMS[length]
        g = sym[rows, :length]
        qp = np.exp(q[rows])
        qmass = np.zeros(g.shape, dtype=np.float64)
        for k in range(4):
            b = _SUBSET[g, k]
            qmass = qmass + np.where(
                b >= 0, np.take_along_axis(qp, np.maximum(b, 0), axis=1),
                0.0)
        # inset[p][m, s, c]: codon c's base p lies in symbol s's subset
        member = _MEMBER[g]  # [m, length, 4]
        inset = [member[:, :, _CODONS[:, p]] for p in range(3)]
        ids = eps_id[rows]
        total = np.zeros((len(rows), 64), dtype=np.float64)
        for t in range(marg_sel.shape[0]):
            coef = np.array([c[cls[t]] for c in coefs])[ids]
            match = np.ones((len(rows), 64), dtype=bool)
            for p in range(3):
                s = marg_sel[t, p]
                if s != frame.ANY:
                    match &= inset[p][:, s]
            qfac = np.full(len(rows), 1.0)
            for k in range(2):
                i = ins_sel[t, k]
                if i != frame.NO_INS:
                    qfac = qfac * qmass[:, i]
            total = total + (coef * qfac)[:, None] * match
        with np.errstate(divide="ignore"):
            post = codonp[rows] + np.log(total)
        out[rows] = np.argmax(post, axis=1)
    return out


_CELLS = [
    (STANDARD_CODE.codon_str(a, b, c), STANDARD_CODE.decode(a, b, c))
    for a, b, c in _CODONS
]


def render_matches(
    hits: list[tuple[ProteinProfile, str, list[tuple[int, int]]]],
) -> tuple[list[str], int]:
    """``render_match(match_steps(prof, seq, path))`` of every (profile,
    read, path) hit, and the number of steps decoded: one walk of each
    path, then every emitting step of all hits in one ``decode_steps``
    call."""
    frags, codonp, q, eps, codes = [], [], [], [], []
    cells = []  # per hit: (frag, state name, step index or -1) a step
    for prof, seq, path in hits:
        seq_idx, read_codes = encode_extended(seq)
        hit_cells = []
        pos = 0
        for state_id, seqlen in path:
            j = -1
            if seqlen > 0 and not st.is_mute(state_id):
                cp, qq = _decode_dists(prof, state_id)
                j = len(frags)
                frags.append(seq_idx[pos : pos + seqlen])
                codonp.append(cp)
                q.append(qq)
                eps.append(prof.cfg.epsilon)
                codes.append(read_codes)
            hit_cells.append((seq[pos : pos + seqlen], st.name(state_id), j))
            pos += seqlen
        cells.append(hit_cells)
    best = decode_steps(frags, np.stack(codonp), np.stack(q),
                        np.asarray(eps), codes) if frags else ()
    out = []
    for hit_cells in cells:
        steps = []
        for frag, name, j in hit_cells:
            codon, amino = _CELLS[best[j]] if j >= 0 else ("", "")
            steps.append(MatchStep(frag, name, codon, amino))
        out.append(render_match(steps))
    return out, len(frags)
