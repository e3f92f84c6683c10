"""The plain reference's codec: a path's steps as match cells.

Each step renders as 'fragment,state,codon,amino'.  A state that emits
decodes its fragment to the codon of highest posterior under its own
codon distribution and the frameshift error model: log p(codon) + log
P(fragment | codon), P summed over the error terms of model.TERMS; the
amino is the codon's translation.  Mute states leave codon and amino
empty.  ``posteriors`` gives the [64] posterior, so that a decoded codon
can be judged by how far it lies below the best.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as rm

SPECIAL = set("SNBEJCT")


def state_name(kind: str, node: int) -> str:
    return kind if kind in SPECIAL else f"{kind}{node + 1}"


def _dists(m: rm.Model, kind: str, node: int):
    if kind == "M":
        return m.match_codonp[node], m.match_q[node]
    if kind == "I":
        return m.insert_codonp, m.insert_q
    return m.null_codonp, m.null_q  # N, J, C share the null distribution


def posteriors(frag: np.ndarray, codonp: np.ndarray, q: np.ndarray,
               eps: float, codes: tuple, dtype=torch.float64) -> np.ndarray:
    """[64] log p(codon) + log P(frag | codon), summed in ``dtype``;
    symbols 4 + j of ``frag`` stand for codes[j].  P sums the error
    terms: a term's codon pattern must agree with the codon at every
    position not deleted, and each inserted symbol weighs its background
    mass."""
    mem = rm.members(codes)  # internal symbol -> nucleotides
    n = len(frag)
    fx = np.append(np.where(frag < 4, frag, frag + 1), 4)  # fx[n]: any, none
    pat, ins, cls = rm.TERMS[n]
    sym = fx[np.where(pat < 0, n, pat)]  # [T, 3]
    agree = np.ones((len(cls), 64))
    for pos in range(3):
        agree *= mem[sym[:, pos]][:, rm.CODON_NT[:, pos]]
    qp = np.exp(q)
    qe = np.concatenate([qp, [1.0], mem[5:] @ qp])
    isym = fx[np.where(ins < 0, n, ins)]  # [T, 2]
    coefs = rm.term_coefs(eps)
    w = np.array([coefs[c] for c in cls]) * qe[isym[:, 0]] * qe[isym[:, 1]]
    with np.errstate(divide="ignore"):
        like = torch.as_tensor(np.log(w @ agree)).to(dtype)
    post = torch.as_tensor(codonp).to(dtype) + like
    return post.double().numpy()


def decode(m: rm.Model, kind: str, node: int, frag: np.ndarray, codes: tuple,
           dtype=torch.float64) -> tuple[int, np.ndarray]:
    """(codon index of the first best posterior, the posteriors)."""
    codonp, q = _dists(m, kind, node)
    post = posteriors(frag, codonp, q, m.eps, codes, dtype)
    return int(np.argmax(post)), post


def cells(m: rm.Model, seq: str, path, dtype=torch.float64) -> list[str]:
    """The match cells of ``path`` [(kind, node, length)] over ``seq``."""
    symbols, codes = rm.encode(seq)
    out, pos = [], 0
    for kind, node, n in path:
        frag = seq[pos : pos + n]
        codon = amino = ""
        if kind in "NJCMI" and n > 0:
            c, _ = decode(m, kind, node, symbols[pos : pos + n], codes, dtype)
            codon = "".join(rm.NUCLT[x] for x in rm.CODON_NT[c])
            amino = rm.CODON_AA[c]
        out.append(f"{frag},{state_name(kind, node)},{codon},{amino}")
        pos += n
    return out
