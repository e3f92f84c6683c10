"""Two-stream leveled logging.

The reference runs a user/sys two-stream logger with [HH:MM:SS] stamps and
file:line context behind a spinlock (reference: src/core/logging.c:55-84,
include/deciphon/core/logging.h:104-156).  Python's logging module already
provides leveled, thread-safe, multi-handler logging, so this module only
configures it to match the reference's output shape and exposes the same
error-macro family (log-and-return-error helpers, logging.h:116-156).
"""

from __future__ import annotations

import logging
import sys

from deciphon_tpu_torch.utils.rc import RC, DcpError

_FORMAT = "[%(asctime)s] %(levelname)s: %(message)s [%(filename)s:%(lineno)d]"
_DATEFMT = "%H:%M:%S"

logger = logging.getLogger("deciphon_tpu")


def setup(level: int = logging.INFO, stream=None) -> None:
    """Configure the framework logger (idempotent)."""
    if logger.handlers:
        logger.setLevel(level)
        return
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    logger.addHandler(handler)
    logger.setLevel(level)


def debug(msg: str, *args) -> None:
    logger.debug(msg, *args, stacklevel=2)


def info(msg: str, *args) -> None:
    logger.info(msg, *args, stacklevel=2)


def warn(msg: str, *args) -> None:
    logger.warning(msg, *args, stacklevel=2)


def error(msg: str, *args) -> None:
    logger.error(msg, *args, stacklevel=2)


def raise_rc(rc: RC, msg: str) -> None:
    """Log an error and raise it — the error-macro family of the reference
    (efail/einval/eio/... log *and* return the rc, logging.h:116-156)."""
    logger.error("%s: %s", rc, msg, stacklevel=2)
    raise DcpError(rc, msg)
