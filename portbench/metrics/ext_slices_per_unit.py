"""Profile slices of extended tables built in one unit: the program's
counter ``ext_slices`` of each unit's scan (one a slice built for a read
class with IUPAC codes; a block under the program's slice budget is one
slice), the mean over the window's units.  Nothing to read where no
scan counted a slice, as in a program that does not count them."""

from portbench.lib import spans


def read(run):
    pairs = spans.scans_of(run)
    if pairs is None:
        return None
    n = sum(s.counts.get("ext_slices", 0) for _, s in pairs)
    return n / len(pairs) if n else None
