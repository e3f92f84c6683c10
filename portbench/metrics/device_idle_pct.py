"""Device idle share of the traced window, in %: the share in which no
kernel, copy or set ran on the card (lib/devtrace.py)."""


def read(run):
    t = run.timeline
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)
