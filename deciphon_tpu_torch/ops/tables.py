"""Device-side synthesis of frame-state fragment score tables, in torch.

The counterpart of deciphon_tpu/ops/tables.py.  Builds the per-node
fragment tables (models/frame.py) on the engine's device from compact
per-node inputs instead of shipping host tables:

    probs[n, f] = sum_t  Me[n, midx(f,t)] * (qq[n, pair(f,t)] * coef_t)

Base-4 tables (ACGT reads, 1365 rows) take the codon marginals [125]
and background nucleotide probabilities [5], as frame.fragment_table
does.  Extended tables over base 4+D (reads holding D distinct IUPAC
codes) take the codon probabilities [64] instead, as
frame.fragment_table_codes does: the [S^3] pattern marginals Me
(S = 5 + D internal symbols) are an f64 product with the 0/1 matrix
frame.ext_agg, and observed symbol 4+j maps to internal symbol 5+j.

The JAX version writes each length's selection as two one-hot matmuls
(tables.py:81-103) and has to pin Precision.HIGHEST, because the TPU
default truncates matmul inputs to bf16 (tables.py:90-97).  Here the
selections are index gathers, summed term by term, so neither TF32 nor
bf16 can enter: every product is an f32 multiply of the selected
entries, and the one matmul (the pattern marginals) runs in f64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from deciphon_tpu_torch.models.frame import (
    IUPAC_SUBSETS,
    TERMS,
    _enumerate_frags,
    ext_agg,
    frag_layout,
    term_coefs,
)
from deciphon_tpu_torch.ops.viterbi_torch import NEG

# elements of one [rows, fragments] temporary: sets the row chunk, so
# base-4 tables go 8192 rows at a time and taller tables fewer
CHUNK_ELEMS = 1 << 23


@functools.cache
def _length_terms(codes: tuple = ()):
    """Per fragment length over base 4+D: (midx [F, T] into the [S^3]
    pattern marginals, pair [F, T] into the [S^2] background pairs,
    class names [T]); S = 5 + D, internal symbol 4 = any / no insertion."""
    base = 4 + len(codes)
    S = 5 + len(codes)
    obs2int = np.concatenate([np.arange(4), np.arange(5, S)])
    out = []
    for length in range(1, 6):
        frags = obs2int[_enumerate_frags(length, base)]  # [F, length]
        F = frags.shape[0]
        fragx = np.concatenate([frags, np.full((F, 1), 4, frags.dtype)], 1)
        marg_sel, ins_sel, cls = TERMS[length]
        sel = np.where(marg_sel < 0, length, marg_sel)
        zabc = fragx[:, sel]  # [F, T, 3]
        midx = (zabc[..., 0] * S + zabc[..., 1]) * S + zabc[..., 2]
        isel = np.where(ins_sel < 0, length, ins_sel)
        iidx = fragx[:, isel]  # [F, T, 2]
        pair = iidx[..., 0] * S + iidx[..., 1]
        out.append((midx.astype(np.int64), pair.astype(np.int64), cls))
    return out


def _ext_inputs(codonp, qp, codes: tuple):
    """(Me [N, S^3], qe [N, S]) f32 for extended tables, from codon
    probabilities [N, 64] and background probabilities [N, 5]: the
    pattern marginals as an f64 product with frame.ext_agg, qe the
    concrete masses, the sentinel 1 and one subset sum per code
    (frame.ext_q)."""
    agg = torch.as_tensor(ext_agg(codes), device=codonp.device)
    me = (codonp.double() @ agg.T).float()
    qe = [qp[:, :4], torch.ones_like(qp[:, :1])]
    qe += [qp[:, list(IUPAC_SUBSETS[c])].sum(1, keepdim=True) for c in codes]
    return me, torch.cat(qe, 1)


def synth_fragment_tables(emis, qp, eps: float, codes: tuple = (),
                          row_chunk: int | None = None):
    """[N, ntab] f32 log fragment tables on the inputs' device, ntab =
    frag_layout(4 + len(codes))[1] + 1 (1365 for base 4).

    Args:
      emis: [N, 125] codon-marginal probabilities (exp of codon_marg)
        for base-4 tables; [N, 64] codon probabilities (exp of the codon
        log-probs) when ``codes`` is not empty.
      qp: [N, 5] background nucleotide probabilities, qp[:, 4] = 1.
      eps: indel error rate.
      codes: the IUPAC codes of the read class (base 4 + len(codes)).

    log(0) clamps to NEG, and the sentinel column (the last) is NEG.
    Rows go in chunks of ``row_chunk`` to bound the [rows, F]
    temporaries."""
    emis = torch.as_tensor(emis, dtype=torch.float32)
    dev = emis.device
    qp = torch.as_tensor(qp, dtype=torch.float32, device=dev)
    codes = tuple(codes)
    if codes:
        emis, qp = _ext_inputs(emis, qp, codes)
    S = qp.shape[1]
    offsets, sentinel = frag_layout(4 + len(codes))
    if row_chunk is None:
        row_chunk = max(1, CHUNK_ELEMS // (4 + len(codes)) ** 5)
    coefs = term_coefs(eps)
    N = emis.shape[0]
    out = torch.empty((N, sentinel + 1), dtype=torch.float32, device=dev)
    out[:, sentinel] = NEG
    terms = [
        (
            torch.as_tensor(midx, device=dev),
            torch.as_tensor(pair, device=dev),
            [float(np.float32(coefs[c])) for c in cls],
        )
        for midx, pair, cls in _length_terms(codes)
    ]
    for r0 in range(0, N, row_chunk):
        mp = emis[r0 : r0 + row_chunk]
        q = qp[r0 : r0 + row_chunk]
        qq = (q[:, :, None] * q[:, None, :]).reshape(q.shape[0], S * S)
        for length, (midx, pair, coef) in enumerate(terms, start=1):
            acc = None
            for t, c in enumerate(coef):
                term = mp[:, midx[:, t]] * (qq[:, pair[:, t]] * c)
                acc = term if acc is None else acc + term
            lo = offsets[length]
            out[r0 : r0 + row_chunk, lo : lo + midx.shape[0]] = (
                torch.log(acc).clamp_min(NEG)
            )
    return out
