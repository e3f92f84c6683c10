"""Viterbi path decoding into codons / amino acids / match strings.

Replaces protein_codec (src/model/protein_codec.c:6-24) and the match
formatter protein_match_write_func (src/server/protein_match.c:21-56):
walking a path, every non-mute step's consumed fragment is decoded to its
most probable intended codon (via the owning state's distribution,
protein_profile_decode, src/model/protein_profile.c:306-331) and the
codon's amino acid.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from deciphon_tpu_torch.models import frame
from deciphon_tpu_torch.models import state as st
from deciphon_tpu_torch.models.alphabet import DNA, STANDARD_CODE
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
    from deciphon_tpu_torch.models.alphabet import encode_extended

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
