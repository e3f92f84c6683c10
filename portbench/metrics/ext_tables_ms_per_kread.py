"""The extended tables of a batch scan, host clock, per thousand reads: the
program's span ``pass1.ext_tables`` (per read class with IUPAC codes and
block: the host packing ``ext_tables.pack`` and the device synthesis's
enqueue ``ext_tables.synth``), summed over the window's batches."""

from portbench.lib import spans


def read(run):
    return spans.span_ms_per_kread(run, "pass1.ext_tables")
