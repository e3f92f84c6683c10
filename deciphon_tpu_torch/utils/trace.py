"""Opt-in tracing/profiling hooks.

The reference's only tracing is an opt-in hex dump of scheduler HTTP
traffic behind a compile flag (reference: src/sched/xcurl_debug.c:98-109,
CMakeLists.txt:34-41). The rebuild's equivalents are environment-gated:

  DCP_DEBUG_HTTP=1      — log every scheduler request/response line
                          (method, path, status, byte sizes)

plus per-scan throughput counters (cell-updates/s) the engine logs at
info level — the device-side analogue of the reference's progress meter.
"""

from __future__ import annotations

import os
import time

from deciphon_tpu_torch.utils import logging as log


def http_debug_enabled() -> bool:
    enabled = bool(os.environ.get("DCP_DEBUG_HTTP"))
    if enabled:
        # the wire log emits at DEBUG; make sure it is visible the moment
        # the env var opts in, whatever level setup() pinned
        import logging as _logging

        if log.logger.getEffectiveLevel() > _logging.DEBUG:
            log.logger.setLevel(_logging.DEBUG)
    return enabled


def log_http(method: str, path: str, status: int, nreq: int, nresp: int):
    """One wire-trace line per scheduler round-trip (xcurl_debug analogue)."""
    log.debug(
        f"http {method} {path} -> {status} ({nreq}B out, {nresp}B in)"
    )


class ScanCounters:
    """Cell-updates/s accounting for one scan (HMMER-GCUPS convention:
    seqs x profiles x positions x core nodes x 3 states, unpadded)."""

    def __init__(self):
        self.cells = 0
        self.t0 = time.perf_counter()

    def consume(self, seq_len_sum: int, core_sum: int):
        # cells for a (seq-bucket x profile-block) tile: per-pair work is
        # seq_len * core_size * 3; sums factorize across the tile
        self.cells += 3 * seq_len_sum * core_sum

    def report(self, label: str = "scan"):
        dt = max(time.perf_counter() - self.t0, 1e-9)
        log.info(
            f"{label}: {self.cells:.3g} cell updates in {dt:.2f}s "
            f"= {self.cells / dt / 1e9:.2f} GCUPS"
        )
        return self.cells / dt
