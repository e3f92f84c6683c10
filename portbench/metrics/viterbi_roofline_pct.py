"""The Viterbi pass-1 kernel's share of its roofline, from the device trace.

The least time of the window's scans under Viterbi (lib/roofline.py:
work and bytes from the reads and the configuration's core sizes) over
the device time of every ``viterbi_kernel`` event in the traced window.
Nothing to read without such an event.
"""


def read(run):
    return run.kernel_roofline("viterbi_kernel", "max")
