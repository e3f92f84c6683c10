"""ctypes bindings for the native (C++) components.

The shared library builds with `make -C native` (g++, no external deps) and
is loaded lazily; every user has a pure-Python fallback, so the framework
works without a toolchain and accelerates when the library is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdcp_native.so")

_lib = None
_lib_tried = False


def _configure(lib) -> None:
    lib.dcp_h3_open.restype = ctypes.c_void_p
    lib.dcp_h3_open.argtypes = [ctypes.c_char_p]
    lib.dcp_h3_close.argtypes = [ctypes.c_void_p]
    lib.dcp_h3_next.restype = ctypes.c_int
    lib.dcp_h3_next.argtypes = [ctypes.c_void_p]
    for fn in ("dcp_h3_error", "dcp_h3_name", "dcp_h3_accession",
               "dcp_h3_residues", "dcp_h3_consensus"):
        getattr(lib, fn).restype = ctypes.c_char_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("dcp_h3_match", "dcp_h3_insert", "dcp_h3_trans"):
        getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_double)
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.dcp_h3_count.restype = ctypes.c_long
    lib.dcp_h3_count.argtypes = [ctypes.c_char_p]


def build(force: bool = False) -> bool:
    """Build the native library (returns True on success).

    make writes a private file name that is then renamed into place, so
    a process that loads the library while another builds it (parallel
    test workers, a CLI beside its parent) never maps a partial file."""
    if os.path.exists(_LIB_PATH) and not force:
        return True
    tmp = os.path.join(_NATIVE_DIR, f".libdcp_native.{os.getpid()}."
                                    f"{threading.get_ident()}.so")
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:  # noqa: BLE001 — fallback path exists
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def load():
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_LIB_PATH) and not build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        _configure(lib)
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return load() is not None
