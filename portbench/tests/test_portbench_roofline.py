"""The roofline's work and bytes against a count by hand."""

import numpy as np
import pytest

from portbench.lib import roofline


def test_work_and_bytes_by_hand():
    sizes = np.array([3, 5])  # K = 8 nodes over P = 2 profiles
    reads = ["ACG", "AAN"]  # one ACGT read, one read of the N class
    node_pos, nbytes = roofline.scan_work(reads, sizes)
    assert node_pos == 3 * 8 + 3 * 8
    # ACG selects A C G, AC CG, ACG: 6 rows; AAN over base 5: A A N,
    # AA AN, AAN: 5 distinct rows
    per_class = lambda rows, L, S: (4 * rows * (8 + 2 * 2) + 4 * 8 * 8
                                    + 4 * (5 * L + 4 * S) + 8 * S * 2)
    assert nbytes == per_class(6, 3, 1) + per_class(5, 3, 1)


def test_least_seconds_takes_the_larger_bound():
    ops = roofline.least_seconds("max", 10**12, 1)
    assert ops == pytest.approx(34e12 / 33.5e12)
    assert roofline.least_seconds("max", 1, 3.35e12) == pytest.approx(1.0)
    fwd = roofline.least_seconds("lse", 10**12, 1)
    mufu = 5e12 / (16 * 132 * 1.98e9)
    assert fwd == pytest.approx(max(30e12 / 67e12 + 18e12 / 33.5e12, mufu))
