"""Opt-in tracing/profiling hooks.

The reference's only tracing is an opt-in hex dump of scheduler HTTP
traffic behind a compile flag (reference: src/sched/xcurl_debug.c:98-109,
CMakeLists.txt:34-41). The rebuild's equivalents are environment-gated:

  DCP_DEBUG_HTTP=1      — log every scheduler request/response line
                          (method, path, status, byte sizes)
  DCP_PROFILE_DIR=path  — wrap a scan in a torch.profiler trace, written
                          as one Chrome trace (chrome://tracing or
                          Perfetto) under <path>/<label>/

plus per-scan throughput counters (cell-updates/s) the engine logs at
info level — the device-side analogue of the reference's progress meter.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def device_trace(label: str = "scan", device=None):
    """torch.profiler trace around a device workload, if DCP_PROFILE_DIR
    is set: CPU activity, and CUDA activity (CUPTI) when ``device`` is a
    GPU.  One Chrome trace per call lands in <DCP_PROFILE_DIR>/<label>/.
    The kernels launch through ctypes, not as torch ops, so they appear
    only as device events under their mangled names (``viterbi_kernel<…>``,
    ``forward_kernel<…>``); the engine's ``record_function`` ranges
    (pass1, gate, pass2) mark the phases."""
    outdir = os.environ.get("DCP_PROFILE_DIR")
    if not outdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    where = os.path.join(outdir, label)
    os.makedirs(where, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(where, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info(f"{label}: profiler trace -> {path}")


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
