"""Build and load the package's CUDA kernels (csrc/*.cu).

``nvcc`` compiles every source into one shared library with a plain C
interface, loaded with ctypes.  The library goes to
``deciphon_tpu_torch/build/``, named by a hash of the sources and flags,
so it is built once per source change and reused after that.  There is
no fallback: a missing compiler or a failed build raises.
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


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    with _LOCK:
        return _library()


def _library() -> ctypes.CDLL:
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libdcp_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        nvcc = _nvcc()  # raises before any file is made
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build under a private name, then rename: concurrent builds
        # (a CLI subprocess beside its parent) never load a partial file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
            capture_output=True, text=True,
        )
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
        os.replace(tmp, out)
        BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (fm, fin, trans, eidx, seq_len, sp, t_EJ, t_EC, alt, nul,
    #  S, B, K, ntab, Lp, stream), one entry point per semiring
    for fn in (lib.dcp_viterbi_max, lib.dcp_viterbi_lse):
        fn.argtypes = [p, p, p, p, p, p, f, f, p, p, i, i, i, i, i, p]
        fn.restype = i
    lib.dcp_cuda_error_string.argtypes = [i]
    lib.dcp_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def error_string(code: int) -> str:
    return f"{code} ({library().dcp_cuda_error_string(code).decode()})"
