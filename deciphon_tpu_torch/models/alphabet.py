"""Alphabets and the genetic code as plain integer/numpy tables.

Replaces the reference's imm alphabet machinery (imm_dna_iupac, imm_amino_iupac,
imm_nuclt_code, imm_gc_* — used via src/server/hmm.c:72-74,
src/model/protein_model.c:342-394) with precomputed index tables.  Symbols and
ordering match imm: DNA "ACGT" (any-symbol 'X' at index 4), amino
"ACDEFGHIKLMNPQRSTVWY" (any-symbol 'X' at index 20).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Alphabet:
    name: str
    symbols: str
    any_symbol: str = "X"

    @property
    def size(self) -> int:
        return len(self.symbols)

    @property
    def any_idx(self) -> int:
        return len(self.symbols)

    def index(self, symbol: str) -> int:
        if symbol == self.any_symbol:
            return self.any_idx
        idx = self.symbols.find(symbol)
        if idx < 0:
            raise ValueError(f"symbol {symbol!r} not in alphabet {self.name}")
        return idx

    def encode(self, seq: str) -> np.ndarray:
        """Encode a string into int8 indices (any-symbol -> any_idx)."""
        table = np.full(256, -1, dtype=np.int8)
        for i, s in enumerate(self.symbols):
            table[ord(s)] = i
            table[ord(s.lower())] = i
        table[ord(self.any_symbol)] = self.any_idx
        table[ord(self.any_symbol.lower())] = self.any_idx
        out = table[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
        if (out < 0).any():
            bad = seq[int(np.argmax(out < 0))]
            raise ValueError(f"symbol {bad!r} not in alphabet {self.name}")
        return out

    def decode(self, idx) -> str:
        full = self.symbols + self.any_symbol
        return "".join(full[int(i)] for i in np.atleast_1d(np.asarray(idx)))


DNA = Alphabet("dna", "ACGT")
RNA = Alphabet("rna", "ACGU")
AMINO = Alphabet("amino", "ACDEFGHIKLMNPQRSTVWY")

# IUPAC nucleotide encoding for metagenomic reads (the reference scans
# with imm_dna_iupac, src/server/hmm.c:72-73 + scan.c:229).  A/C/G/T map
# to 0..3, U to T, and every ambiguity code to 4 = N, scored as the exact
# marginal over A/C/G/T by the base-5 fragment tables (models/frame.py).
# For partially-degenerate codes (R, Y, ...) the N marginal is a
# documented superset approximation.
_IUPAC_TABLE = np.full(256, -1, dtype=np.int8)
for _i, _s in enumerate("ACGT"):
    _IUPAC_TABLE[ord(_s)] = _i
    _IUPAC_TABLE[ord(_s.lower())] = _i
for _s in "UuTt":
    _IUPAC_TABLE[ord(_s)] = 3
for _s in "NXRYSWKMBDHV":
    _IUPAC_TABLE[ord(_s)] = 4
    _IUPAC_TABLE[ord(_s.lower())] = 4


def encode_iupac(seq: str) -> np.ndarray:
    """Encode DNA with IUPAC ambiguity codes: ACGT -> 0..3, U -> 3,
    N/X and partial codes -> 4.  Raises on non-IUPAC symbols.

    NOTE: collapses partial codes to N (superset approximation); the
    scan engine uses ``encode_extended`` for exact subset scoring."""
    out = _IUPAC_TABLE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    if (out < 0).any():
        bad = seq[int(np.argmax(out < 0))]
        raise ValueError(f"symbol {bad!r} is not an IUPAC nucleotide code")
    return out


# per-letter identity of the ambiguity codes (X folds into N)
_IUPAC_LETTERS = "NRYSWKMBDHV"
_IUPAC_LETTER_TABLE = np.full(256, -1, dtype=np.int8)
for _j, _s in enumerate(_IUPAC_LETTERS):
    _IUPAC_LETTER_TABLE[ord(_s)] = _j
    _IUPAC_LETTER_TABLE[ord(_s.lower())] = _j
_IUPAC_LETTER_TABLE[ord("X")] = 0
_IUPAC_LETTER_TABLE[ord("x")] = 0


def encode_extended(seq: str) -> tuple[np.ndarray, tuple[str, ...]]:
    """Exact IUPAC encoding: ACGT -> 0..3 (U -> 3); each DISTINCT
    ambiguity code present in the read becomes one extra symbol 4+j
    (codes sorted, X folded into N).  Returns (encoded, codes).

    The scan scores symbol 4+j as the exact marginal over
    frame.IUPAC_SUBSETS[codes[j]] — the subset-exact refinement of the
    reference's imm_dna_iupac alphabet (src/server/hmm.c:72-73)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    base = _IUPAC_TABLE[raw]
    if (base < 0).any():
        bad = seq[int(np.argmax(base < 0))]
        raise ValueError(f"symbol {bad!r} is not an IUPAC nucleotide code")
    amb = base == 4
    if not amb.any():
        return base, ()
    letters = _IUPAC_LETTER_TABLE[raw[amb]]
    present = sorted({_IUPAC_LETTERS[j] for j in np.unique(letters)})
    codes = tuple(present)
    out = base.astype(np.int8)
    remap = np.full(len(_IUPAC_LETTERS), -1, dtype=np.int8)
    for i, c in enumerate(codes):
        remap[_IUPAC_LETTERS.index(c)] = 4 + i
    out[amb] = remap[letters]
    return out, codes

# NCBI translation table 1 (standard), codon base order TCAG in the canonical
# listing; '*' marks stop codons.  Equivalent to the reference's imm_gc table
# id 1 (imm_gc_codon/imm_gc_aa/imm_gc_decode usage in protein_model.c:349-389).
_NCBI_AAS = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_NCBI_BASE_ORDER = "TCAG"


class GeneticCode:
    """Codon -> amino acid mapping over a nucleotide alphabet.

    ``aa_of[64]``: amino index (0..19) or -1 for stop, indexed by
    16*a + 4*b + c with a,b,c nucleotide indices in DNA ("ACGT") order.
    """

    def __init__(self, nuclt: Alphabet = DNA):
        self.nuclt = nuclt
        self.aa_char = np.empty(64, dtype="<U1")
        self.aa_of = np.full(64, -1, dtype=np.int32)
        for i, aa in enumerate(_NCBI_AAS):
            b1 = _NCBI_BASE_ORDER[i // 16]
            b2 = _NCBI_BASE_ORDER[(i // 4) % 4]
            b3 = _NCBI_BASE_ORDER[i % 4]
            if nuclt.symbols == "ACGU":
                b1, b2, b3 = (b.replace("T", "U") for b in (b1, b2, b3))
            idx = (
                16 * nuclt.index(b1) + 4 * nuclt.index(b2) + nuclt.index(b3)
            )
            self.aa_char[idx] = aa
            self.aa_of[idx] = AMINO.index(aa) if aa != "*" else -1
        # codons per amino acid (degeneracy count), reference
        # protein_model.c:366-369 counts them to split aa mass over codons.
        self.ncodons_per_aa = np.zeros(AMINO.size, dtype=np.int32)
        for idx in range(64):
            if self.aa_of[idx] >= 0:
                self.ncodons_per_aa[self.aa_of[idx]] += 1

    def decode(self, a: int, b: int, c: int) -> str:
        """Codon indices -> amino acid character ('*' for stop)."""
        return str(self.aa_char[16 * int(a) + 4 * int(b) + int(c)])

    def codon_str(self, a: int, b: int, c: int) -> str:
        return self.nuclt.decode([a, b, c])


STANDARD_CODE = GeneticCode(DNA)
