"""The forward pass-1 kernel's share of its roofline, from the device trace.

The least time of the window's scans under forward (lib/roofline.py:
the larger of the f32 time, the MUFU time and the bytes' time) over the
device time of every ``forward_kernel`` event in the traced window.
Nothing to read without such an event.
"""


def read(run):
    return run.kernel_roofline("forward_kernel", "lse")
