"""Math helpers: LRT statistic and balanced partition sizing.

Reference: include/deciphon/core/xmath.h:228-247.
"""

from __future__ import annotations

import numpy as np

LOG0 = -np.inf


def lrt(null_loglik, alt_loglik):
    """Likelihood-ratio-test statistic -2*(ln L0 - ln L1).

    Reference: xmath.h:236-247 (xmath_lrt).  Works on scalars or arrays.
    """
    return -2.0 * (np.asarray(null_loglik) - np.asarray(alt_loglik))


def partition_size(nelems: int, nparts: int, idx: int) -> int:
    """Size of partition ``idx`` when splitting ``nelems`` into ``nparts``
    balanced contiguous chunks (remainder spread over the first chunks).

    Reference: xmath.h:228-234 (xmath_partition_size).
    """
    size = nelems // nparts
    rem = nelems % nparts
    return size + (1 if idx < rem else 0)


def partition_starts(nelems: int, nparts: int) -> list[int]:
    """Start offsets (plus final sentinel nelems) of the balanced partitions."""
    starts = [0]
    for i in range(nparts):
        starts.append(starts[-1] + partition_size(nelems, nparts, i))
    return starts


def logsumexp(a, axis=None):
    """Numerically stable log-sum-exp (numpy)."""
    a = np.asarray(a, dtype=np.float64)
    m = np.max(a, axis=axis, keepdims=True)
    m_safe = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        out = (
            np.log(np.sum(np.exp(a - m_safe), axis=axis, keepdims=True))
            + m_safe
        )
    out = np.where(np.isfinite(m), out, m)  # all -inf -> -inf
    if axis is not None:
        out = np.squeeze(out, axis=axis)
    else:
        out = out.reshape(())
    return out


def log1mexp(logp):
    """log(1 - exp(logp)) for logp <= 0.

    Used by the occupancy recurrence (reference: src/model/protein_model.c:18
    log1_p).
    """
    logp = np.asarray(logp, dtype=np.float64)
    return np.log1p(-np.exp(logp))
