"""Return-code model.

Mirrors the 9-value ``enum rc`` threaded through every reference API
(reference: include/deciphon/core/rc.h:162-186), re-expressed idiomatically:
Python raises ``DcpError`` carrying an ``RC``; job-level code catches it and
reports failure to the scheduler, like the reference's ``job_set_fail``
(reference: src/server/job.c:44-56).
"""

from __future__ import annotations

import enum


class RC(enum.IntEnum):
    OK = 0
    END = 1
    EFAIL = 2
    EINVAL = 3
    EIO = 4
    ENOMEM = 5
    EPARSE = 6
    EAPI = 7
    EHTTP = 8

    def __str__(self) -> str:  # rc.h:175-186 stringifier parity
        return self.name


class DcpError(Exception):
    """Error carrying a return code, optionally an HTTP/API payload."""

    def __init__(self, rc: RC, msg: str = ""):
        super().__init__(f"{rc}: {msg}" if msg else str(rc))
        self.rc = rc
        self.msg = msg


class EndOfData(Exception):
    """Analogue of RC_END: an iterator/stream is exhausted (not an error)."""


def efail(msg: str) -> DcpError:
    return DcpError(RC.EFAIL, msg)


def einval(msg: str) -> DcpError:
    return DcpError(RC.EINVAL, msg)


def eio(msg: str) -> DcpError:
    return DcpError(RC.EIO, msg)


def eparse(msg: str) -> DcpError:
    return DcpError(RC.EPARSE, msg)


def eapi(msg: str) -> DcpError:
    return DcpError(RC.EAPI, msg)


def ehttp(msg: str) -> DcpError:
    return DcpError(RC.EHTTP, msg)
