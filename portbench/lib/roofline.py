"""The pass-1 kernels' least time on the card, from the problem's shapes.

Work is counted from the traffic and the configuration alone, whatever
kernel runs it: a node-position is one (read position, unpadded core
node) of a (read, profile) pair.  Viterbi costs 34 f32 instructions a
node-position (18 adds, 15 maxima, 1 clamp: the recurrence as the
plain version writes it); forward 15 FMAs, 18 other f32 instructions and
5 exponentials on the MUFU pipe.  Bytes, for each read class of a scan
(reads sharing one set of IUPAC codes): the fragment rows its reads'
symbols select, 4 B for each core node and for the insert and null
tables; 8 transition planes of 4 B a node; each read's fragment indices
(5 x 4 B a position), length and 3 specials; and two 4-B outputs a
(read, profile) pair.  Each counts once.

Peaks are published figures for the H100 SXM at 700 W: 67 TFLOP/s f32
outside the tensor cores (an FMA two operations, so 33.5 T other f32
instructions a second), 16 MUFU lanes an SM x 132 SMs x 1.98 GHz (the
CUDA programming guide's throughput table), 3.35 TB/s of HBM.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import model as rm

PEAK_F32 = 67e12
OTHER_F32 = PEAK_F32 / 2
PEAK_MUFU = 16 * 132 * 1.98e9
PEAK_BYTES = 3.35e12
VITERBI_OPS = 34
FWD_FMA, FWD_OTHER, FWD_MUFU = 15, 18, 5


def scan_work(reads: list[str], sizes: np.ndarray) -> tuple[int, int]:
    """(node-positions, bytes) of one scan's pass-1 launches."""
    K, P = int(np.sum(sizes)), len(sizes)
    classes: dict[tuple, list] = {}
    for s in reads:
        classes.setdefault(rm.encode(s)[1], []).append(rm.encode(s)[0])
    node_pos = nbytes = 0
    for codes, enc in classes.items():
        base = 4 + len(codes)
        rows = set()
        for e in enc:
            f = rm.fragment_starts(e, base, len(e))
            rows.update(np.unique(f[f < rm.layout(base)[1]]).tolist())
        L = sum(len(e) for e in enc)
        node_pos += L * K
        nbytes += 4 * len(rows) * (K + 2 * P) + 4 * 8 * K
        nbytes += 4 * (5 * L + 4 * len(enc)) + 8 * len(enc) * P
    return node_pos, nbytes


def least_seconds(semiring: str, node_pos: int, nbytes: int) -> float:
    """The larger of the arithmetic's time and the bytes' time."""
    if semiring == "max":
        ops = node_pos * VITERBI_OPS / OTHER_F32
    else:
        ops = node_pos * max(2 * FWD_FMA / PEAK_F32 + FWD_OTHER / OTHER_F32,
                             FWD_MUFU / PEAK_MUFU)
    return max(ops, nbytes / PEAK_BYTES)
