"""HMMER3 ASCII profile (.hmm) reader.

Replaces the external ``hmr`` parser + protein_h3reader glue the reference
uses (src/model/protein_h3reader.c:18-72; hmr via CMakeLists.txt:12).
Streams profiles out of a HMMER3/f (or /b) save file and feeds the tensor
profile builder.

File facts used here (HMMER3 save-file format):
  - header stanza NAME/ACC/LENG/ALPH/... terminated by the "HMM" column
    header (two lines: residue order, transition order);
  - an optional COMPO line, then the BEGIN node (insert-0 emissions line +
    transition line), then per core node k: match line (node index, 20
    scores, MAP/CONS/RF/[MM]/CS annotation columns), insert line,
    transition line; profile ends with "//";
  - all scores are negated natural logs (-ln p); '*' encodes p = 0.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from deciphon_tpu_torch.models.alphabet import AMINO
from deciphon_tpu_torch.models.profile import (
    NULL_AMINO_LPROBS,
    ProteinCfg,
    ProteinModelBuilder,
    ProteinProfile,
)
from deciphon_tpu_torch.utils.rc import eparse

NEG = -np.inf


@dataclass
class H3Profile:
    """One parsed HMMER3 profile (natural-log probabilities)."""

    name: str
    accession: str
    length: int
    match_lprobs: np.ndarray  # [K, 20] ln p, in AMINO order
    insert_lprobs: np.ndarray  # [K, 20] ln p (unused by the protein model)
    trans: np.ndarray  # [K+1, 7] ln p: MM MI MD IM II DM DD; row 0 = BEGIN
    consensus: str = ""


def _score(tok: str) -> float:
    return NEG if tok == "*" else -float(tok)


def _scores(toks) -> np.ndarray:
    return np.array([_score(t) for t in toks], dtype=np.float64)


def read_h3(fp) -> Iterator[H3Profile]:
    """Yield profiles from an open text stream (or iterate a whole file)."""
    if isinstance(fp, str):
        with open(fp, "r", encoding="utf-8", errors="replace") as f:
            yield from read_h3(f)
            return

    line_iter = iter(fp)

    def next_line():
        for raw in line_iter:
            s = raw.strip()
            if s:
                return s
        return None

    while True:
        # ---- header stanza ----
        line = next_line()
        if line is None:
            return
        if not line.startswith("HMMER3"):
            raise eparse(f"expected HMMER3 magic, got {line[:30]!r}")
        name = ""
        acc = ""
        leng = 0
        alpha = "amino"
        cons_flag = True
        while True:
            line = next_line()
            if line is None:
                raise eparse("truncated HMMER3 header")
            if line.startswith("HMM "):
                break
            key, _, val = line.partition(" ")
            val = val.strip()
            if key == "NAME":
                name = val
            elif key == "ACC":
                acc = val
            elif key == "LENG":
                leng = int(val)
            elif key == "ALPH":
                alpha = val.lower()
            elif key == "CONS":
                cons_flag = val.lower() == "yes"
        if alpha != "amino":
            raise eparse(f"only amino HMMs are supported, got {alpha}")
        if leng <= 0:
            raise eparse("missing or invalid LENG")
        # residue order from the HMM header line itself
        residues = line.split()[1:]
        if len(residues) != 20:
            raise eparse("expected 20 residues in HMM header")
        perm = np.array([AMINO.index(r) for r in residues])
        inv_perm = np.empty(20, dtype=np.int64)
        inv_perm[perm] = np.arange(20)

        next_line()  # transition header line (m->m m->i ...)

        # ---- BEGIN node (optional COMPO line first) ----
        line = next_line()
        if line is None:
            raise eparse("truncated profile body")
        if line.startswith("COMPO"):
            line = next_line()
        insert0 = _scores(line.split()[:20])[inv_perm]
        line = next_line()
        trans = [np.array([_score(t) for t in line.split()[:7]])]

        match = np.empty((leng, 20), dtype=np.float64)
        inserts = np.empty((leng, 20), dtype=np.float64)
        cons_chars = []
        for k in range(leng):
            mline = next_line()
            if mline is None:
                raise eparse("truncated node stanza")
            toks = mline.split()
            if int(toks[0]) != k + 1:
                raise eparse(
                    f"unexpected node index {toks[0]} (wanted {k + 1})"
                )
            match[k] = _scores(toks[1 : 21])[inv_perm]
            # annotation columns: MAP CONS RF [MM] CS — CONS is the second
            ann = toks[21:]
            cons_chars.append(
                ann[1] if cons_flag and len(ann) >= 2 else "-"
            )
            iline = next_line()
            inserts[k] = _scores(iline.split()[:20])[inv_perm]
            tline = next_line()
            trans.append(_scores(tline.split()[:7]))
        del insert0  # parity note: the reference discards them too

        end = next_line()
        if end != "//":
            raise eparse(f"expected '//' profile terminator, got {end!r}")

        yield H3Profile(
            name=name,
            accession=acc or name,
            length=leng,
            match_lprobs=match,
            insert_lprobs=inserts,
            trans=np.stack(trans),
            consensus="".join(cons_chars),
        )


def count_profiles(path: str) -> int:
    """Number of profiles in a .hmm file (reference: hmr_count_profiles
    used by src/server/hmm.c:128)."""
    n = 0
    with open(path, "r", encoding="utf-8", errors="replace") as fp:
        for line in fp:
            if line.startswith("//"):
                n += 1
    return n


def build_profile(
    h3: H3Profile, cfg: ProteinCfg = ProteinCfg()
) -> ProteinProfile:
    """Compile one parsed HMMER3 profile into its dense tensor form.

    Mirrors the reference press path protein_h3reader_next ->
    protein_model_{setup,add_trans,add_node} -> protein_profile_absorb
    (src/model/protein_h3reader.c:18-72, src/server/hmm.c:33-40), with the
    fixed Swiss-Prot null frequencies (protein_h3reader.c:79-103).
    """
    b = ProteinModelBuilder(cfg, null_lprobs=NULL_AMINO_LPROBS)
    b.setup(h3.length)
    b.add_trans(h3.trans[0])
    for k in range(h3.length):
        b.add_node(h3.match_lprobs[k], h3.consensus[k])
        b.add_trans(h3.trans[k + 1])
    return b.finalize(accession=h3.accession, name=h3.name)


def press_file(
    hmm_path: str, cfg: ProteinCfg = ProteinCfg(), use_native: bool = True
) -> Iterator[ProteinProfile]:
    """Stream-compile every profile of a .hmm file.

    Prefers the C++ tokenizer (deciphon_tpu_torch.native) when its shared library
    is available; falls back to the pure-Python reader transparently.
    """
    reader = read_h3
    if use_native:
        try:  # lazy import: native.h3parse imports this module
            from deciphon_tpu_torch.native.h3parse import read_h3_native

            reader = read_h3_native
        except Exception:  # noqa: BLE001 — fallback always works
            pass
    for h3 in reader(hmm_path):
        yield build_profile(h3, cfg)
