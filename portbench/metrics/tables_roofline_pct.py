"""The extended tables' kernel's share of its roofline, from the device
trace and the program's counters.

csrc/tables.cu is bound by what it writes: each launch writes the fm and
fin of one profile slice of a read class with IUPAC codes, counted by
the program as ``tables_written_bytes`` (``WRITTEN``) in the unit's
scan.  The least time is the bytes written over the window's units at
the card's published 3.35 TB/s of HBM (lib/roofline.PEAK_BYTES); the
share is that over the device time of every ``tables_kernel`` event in
the traced window.  It reads only what the kernel writes: the program's
``ext_table_bytes`` also counts the base tile's transition planes,
which the kernel does not write.  Nothing to read without both the
counter and such an event.
"""

from portbench.lib import roofline, spans

WRITTEN = "tables_written_bytes"
KERNEL = "tables_kernel"


def read(run):
    if run.timeline is None:
        return None
    t = run.timeline.kernel_s(KERNEL)
    pairs = spans.scans_of(run)
    if t <= 0 or pairs is None:
        return None
    nbytes = sum(s.counts.get(WRITTEN, 0) for _, s in pairs)
    return 100.0 * nbytes / roofline.PEAK_BYTES / t if nbytes else None
