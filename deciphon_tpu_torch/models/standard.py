"""Standard (non-codon) profiles: generic dense HMMs, typeid 1.

A host copy of deciphon_tpu/models/standard.py.

The reference's standard profile kind wraps two arbitrary packed imm_dp
matrices — null and alt — over any alphabet, with states named by bare
index (src/model/standard_profile.c:22-63, src/model/standard_state.c:
124-129).  It is vestigial there: the db reader only ever instantiates
the PROTEIN kind (src/db/profile_reader.c:95-98), but the type exists in
the typeid enum (src/model/profile_typeid.h:4-9) and the scan vtable
dispatches through it (src/model/profile.h:11-18).

This module provides the tensor-era counterpart: a dense generic HMM
(single-symbol emissions, arbitrary transition matrix, explicit start /
end weights) with a batched torch Viterbi in ops/viterbi_standard.py and a
msgpack container alongside the protein .dtp format.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from deciphon_tpu_torch.models.alphabet import Alphabet, DNA
from deciphon_tpu_torch.utils.rc import einval

NEG = -1e30


@dataclass
class StandardProfile:
    """One generic profile: two dense single-emission HMMs (null, alt).

    Arrays are log-probabilities (float64 host-side):
      alt_start [S]    entry weight of each state (consumed at the first
                       emitted symbol)
      alt_trans [S, S] trans[i, j] = log P(i -> j)
      alt_emis  [S, A] per-state symbol emission
      alt_end   [S]    termination weight
    and the null_* quadruple likewise (typically a 1-state loop).
    """

    accession: str
    abc: Alphabet
    alt_start: np.ndarray
    alt_trans: np.ndarray
    alt_emis: np.ndarray
    alt_end: np.ndarray
    null_start: np.ndarray
    null_trans: np.ndarray
    null_emis: np.ndarray
    null_end: np.ndarray
    name: str = ""

    def __post_init__(self):
        S, A = self.alt_emis.shape
        if self.alt_trans.shape != (S, S):
            raise einval("alt_trans must be [nstates, nstates]")
        if A != len(self.abc.symbols):
            raise einval("emission width must match the alphabet")

    @property
    def nstates(self) -> int:
        return self.alt_emis.shape[0]

    def state_name(self, i: int) -> str:
        from deciphon_tpu_torch.models import state as st

        return st.standard_name(i)


def loop_null(abc: Alphabet, sym_lprobs: np.ndarray) -> tuple:
    """(start, trans, emis, end) of a 1-state self-loop null model —
    the standard counterpart of the protein R loop."""
    sym_lprobs = np.asarray(sym_lprobs, dtype=np.float64)
    return (
        np.zeros(1),
        np.zeros((1, 1)),
        sym_lprobs[None, :],
        np.zeros(1),
    )


def sample_standard(
    seed: int, nstates: int, abc: Alphabet = DNA
) -> StandardProfile:
    """Deterministic random standard profile (test/bench helper, the
    counterpart of protein sample_profile / the reference's
    standard_profile test fixtures)."""
    rng = np.random.default_rng(seed)
    A = len(abc.symbols)

    def lrow(n):
        p = rng.dirichlet(np.ones(n))
        return np.log(p)

    alt_start = lrow(nstates)
    alt_trans = np.stack([lrow(nstates) for _ in range(nstates)])
    alt_emis = np.stack([lrow(A) for _ in range(nstates)])
    alt_end = np.full(nstates, np.log(0.1))
    ns, nt, ne, nn = loop_null(abc, lrow(A))
    return StandardProfile(
        accession=f"STD{seed:05d}",
        abc=abc,
        alt_start=alt_start, alt_trans=alt_trans,
        alt_emis=alt_emis, alt_end=alt_end,
        null_start=ns, null_trans=nt, null_emis=ne, null_end=nn,
        name=f"STD{seed:05d}",
    )
