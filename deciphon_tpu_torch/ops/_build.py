"""Build and load the package's CUDA kernels (csrc/*.cu).

``nvcc`` compiles each source into a shared library of its own, with a
plain C interface, one process per source and all of them at once; they
are loaded with ctypes.  The libraries go to a directory under
``deciphon_tpu_torch/build/`` named by a hash of the sources (headers
included) and flags, so they are built once per source change and reused
after that.  There is no fallback: a missing compiler or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

from deciphon_tpu_torch.utils import trace

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIB = None
_LOCK = threading.Lock()  # a prewarm thread may build beside a scan
BUILD_LOG = ""  # nvcc's output of the last build (ptxas register report)
BUILD_SECONDS = 0.0  # wall time of the last build (0 when it was reused)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library() -> SimpleNamespace:
    """The kernels' entry points, built first if needed."""
    with _LOCK:
        return _library()


def _library() -> SimpleNamespace:
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"kernels_{h.hexdigest()[:16]}"
    if not out.exists():
        nvcc = _nvcc()  # raises before any file is made
        trace.count("library_builds")  # a scan that had to run nvcc
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build into a private directory, then rename it: concurrent
        # builds (a CLI subprocess beside its parent) never load a
        # partial file, and the loser of a race drops its own copy
        tmp = tempfile.mkdtemp(dir=BUILD_DIR)
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", os.path.join(tmp, f"{src.stem}.so"),
                 str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src in sources
        ]
        logs = [p.communicate()[0] for p in procs]
        BUILD_LOG = "".join(
            f"[{src.name}]\n{log}" for src, log in zip(sources, logs))
        if any(p.returncode != 0 for p in procs):
            shutil.rmtree(tmp)
            raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
        try:
            os.rename(tmp, out)
        except OSError:
            shutil.rmtree(tmp)
        BUILD_SECONDS = time.perf_counter() - t0
    viterbi = ctypes.CDLL(str(out / "viterbi.so"))
    forward = ctypes.CDLL(str(out / "forward.so"))
    traceback = ctypes.CDLL(str(out / "traceback.so"))
    tables = ctypes.CDLL(str(out / "tables.so"))
    lib = SimpleNamespace(
        dcp_viterbi_max=viterbi.dcp_viterbi_max,
        dcp_viterbi_lse=forward.dcp_viterbi_lse,
        dcp_traceback=traceback.dcp_traceback,
        dcp_tables=tables.dcp_tables,
        dcp_cuda_error_string=viterbi.dcp_cuda_error_string,
    )
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (fm, fin, trans, eidx, seq_len, sp, t_EJ, t_EC, alt, nul,
    #  S, B, K, ntab, Lp, [plan,] stream), one entry point per semiring:
    #  the Viterbi kernel (viterbi.cu) takes the log planes `trans` and
    #  its launch plan (npt, kernel_warps, reg_ring, warps, reads, smem;
    #  viterbi_cuda.viterbi_plan), the forward kernel (forward.cu) the
    #  probability planes `ptrans`
    common = [p, p, p, p, p, p, f, f, p, p, i, i, i, i, i]
    lib.dcp_viterbi_max.argtypes = common + [i] * 6 + [p]
    lib.dcp_viterbi_lse.argtypes = common + [p]
    # the traceback kernel (traceback.cu): (fmT, fin, planes, eidx, sp,
    #  t_EJ, t_EC, bpM, bpI, dD, bpE, bpN, bpJ, bpC, bpB, bpT, VT, H, K,
    #  ntab, Lmax, and its plan: kind, npt, warps, cluster, threads,
    #  smem; stream); viterbi_trace.launch_trace
    lib.dcp_traceback.argtypes = (
        [p] * 5 + [f, f] + [p] * 10 + [i] * 10 + [p])
    # the table synthesis (tables.cu): (me, qe, start, word, combo, coef,
    #  fm, fin, B, Kp, ntab, S, ncombo, stream); ops/tables.launch_tables
    lib.dcp_tables.argtypes = [p] * 8 + [i] * 5 + [p]
    for fn in (lib.dcp_viterbi_max, lib.dcp_viterbi_lse, lib.dcp_traceback,
               lib.dcp_tables):
        fn.restype = i
    lib.dcp_cuda_error_string.argtypes = [i]
    lib.dcp_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def error_string(code: int) -> str:
    return f"{code} ({library().dcp_cuda_error_string(code).decode()})"
