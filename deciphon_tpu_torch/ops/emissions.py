"""Sequence encoding into fragment-table indices.

A scan evaluates frame-state emissions as lookups into per-state fragment
score tables F[1365] (see models/frame.py).  For a given DNA sequence the
only per-position data the DP needs is, for every start position i and
length l in 1..5, the index of fragment seq[i:i+l] — an int32 [L, 5] array
computed once per sequence here (host- or device-side; this is the numpy
version shared by every engine).
"""

from __future__ import annotations

import numpy as np

from deciphon_tpu_torch.models.frame import frag_layout


def fragment_indices(
    seq_idx: np.ndarray, pad_to: int | None = None, base: int = 4
) -> np.ndarray:
    """[Lp, 5] int32: fragidx[i, l-1] = index of seq[i:i+l], SENTINEL if
    the fragment would run past the end of the sequence.

    ``seq_idx`` is the int-encoded sequence (values 0..3, or 0..4 with
    base=5 where 4 = IUPAC N).  ``pad_to`` pads the output with sentinel
    rows (for length-bucketed batching).
    """
    offsets, sentinel = frag_layout(base)
    seq_idx = np.asarray(seq_idx, dtype=np.int64)
    L = len(seq_idx)
    Lp = pad_to if pad_to is not None else L
    out = np.full((Lp, 5), sentinel, dtype=np.int32)
    code = np.zeros(L, dtype=np.int64)
    for l in range(1, 6):
        # code[i] = base-b value of seq[i:i+l] for i <= L-l
        n = L - l + 1
        if n <= 0:
            break
        if l == 1:
            code = seq_idx.copy()
        else:
            code = code[: L - l + 1] * base + seq_idx[l - 1 :]
        out[:n, l - 1] = offsets[l] + code[:n]
    return out
