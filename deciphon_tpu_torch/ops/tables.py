"""Device-side synthesis of frame-state fragment score tables, in torch.

The counterpart of deciphon_tpu/ops/tables.py.  Builds the per-node
fragment tables F[1365] (models/frame.py) on the engine's device from the
compact per-node inputs (codon marginals [125] + background nucleotide
probabilities [5]) instead of shipping host tables:

    probs[n, f] = sum_t  Mp[n, midx(f,t)] * (qq[n, pair(f,t)] * coef_t)

The JAX version writes each length's selection as two one-hot matmuls
(tables.py:81-103) and has to pin Precision.HIGHEST, because the TPU
default truncates matmul inputs to bf16 (tables.py:90-97).  Here the
selections are index gathers, summed term by term, so neither TF32 nor
bf16 can enter: every product is an f32 multiply of the selected entries.
"""

from __future__ import annotations

import numpy as np
import torch

from deciphon_tpu.models.frame import (
    FRAG_OFFSET,
    FRAG_SENTINEL,
    NFRAGS,
    TERMS,
    _enumerate_frags,
    term_coefs,
)
from deciphon_tpu_torch.ops.viterbi_torch import NEG

NTAB = FRAG_SENTINEL + 1


def _length_terms():
    """Per fragment length: (midx [F, T], pair [F, T], class names [T])."""
    out = []
    for length in range(1, 6):
        frags = _enumerate_frags(length)  # [F, length]
        F = frags.shape[0]
        fragx = np.concatenate([frags, np.full((F, 1), 4, frags.dtype)], 1)
        marg_sel, ins_sel, cls = TERMS[length]
        sel = np.where(marg_sel < 0, length, marg_sel)
        zabc = fragx[:, sel]  # [F, T, 3], 4 = any
        midx = zabc[..., 0] * 25 + zabc[..., 1] * 5 + zabc[..., 2]
        isel = np.where(ins_sel < 0, length, ins_sel)
        iidx = fragx[:, isel]  # [F, T, 2], 4 = no insertion
        pair = iidx[..., 0] * 5 + iidx[..., 1]
        out.append((midx.astype(np.int64), pair.astype(np.int64), cls))
    return out


_TERMS = _length_terms()


def synth_fragment_tables(margp, qp, eps: float, row_chunk: int = 8192):
    """[N, NTAB] f32 log fragment tables on the inputs' device.

    Args:
      margp: [N, 125] codon-marginal probabilities (exp of codon_marg).
      qp: [N, 5] background nucleotide probabilities, qp[:, 4] = 1.
      eps: indel error rate.

    log(0) clamps to NEG, and the sentinel column is NEG.  Rows go in
    chunks of ``row_chunk`` to bound the [rows, F] temporaries."""
    margp = torch.as_tensor(margp, dtype=torch.float32)
    qp = torch.as_tensor(qp, dtype=torch.float32, device=margp.device)
    dev = margp.device
    coefs = term_coefs(eps)
    N = margp.shape[0]
    out = torch.empty((N, NTAB), dtype=torch.float32, device=dev)
    out[:, NFRAGS] = NEG
    terms = [
        (
            torch.as_tensor(midx, device=dev),
            torch.as_tensor(pair, device=dev),
            [float(np.float32(coefs[c])) for c in cls],
        )
        for midx, pair, cls in _TERMS
    ]
    for r0 in range(0, N, row_chunk):
        mp = margp[r0 : r0 + row_chunk]
        q = qp[r0 : r0 + row_chunk]
        qq = (q[:, :, None] * q[:, None, :]).reshape(q.shape[0], 25)
        for length, (midx, pair, coef) in enumerate(terms, start=1):
            acc = None
            for t, c in enumerate(coef):
                term = mp[:, midx[:, t]] * (qq[:, pair[:, t]] * c)
                acc = term if acc is None else acc + term
            lo = FRAG_OFFSET[length]
            out[r0 : r0 + row_chunk, lo : lo + midx.shape[0]] = (
                torch.log(acc).clamp_min(NEG)
            )
    return out
