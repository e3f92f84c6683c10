"""Scheduler entity dataclasses.

Plain mirrors of the deciphon-sched REST schema the reference binds from
JSON (src/sched/sched.c:20-220; struct definitions come from the external
SCHED::headers package, sched.h:4).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class JobState(enum.Enum):
    PEND = "pend"
    RUN = "run"
    DONE = "done"
    FAIL = "fail"


class JobType(enum.IntEnum):
    """Dispatch index — order matches the reference's fn table
    {scan_run, hmm_press} (src/server/job.c:18)."""

    SCAN = 0
    HMM = 1


@dataclass
class SchedJob:
    id: int = 0
    type: int = 0
    state: str = "pend"
    progress: int = 0
    error: str = ""
    submission: int = 0
    exec_started: int = 0
    exec_ended: int = 0

    @classmethod
    def from_json(cls, d: dict) -> "SchedJob":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass
class SchedHmm:
    id: int = 0
    xxh3: int = 0
    filename: str = ""
    job_id: int = 0

    @classmethod
    def from_json(cls, d: dict) -> "SchedHmm":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass
class SchedDb:
    id: int = 0
    xxh3: int = 0
    filename: str = ""
    hmm_id: int = 0

    @classmethod
    def from_json(cls, d: dict) -> "SchedDb":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass
class SchedScan:
    id: int = 0
    db_id: int = 0
    multi_hits: bool = True
    hmmer3_compat: bool = False
    job_id: int = 0

    @classmethod
    def from_json(cls, d: dict) -> "SchedScan":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass
class SchedSeq:
    id: int = 0
    scan_id: int = 0
    name: str = ""
    data: str = ""

    @classmethod
    def from_json(cls, d: dict) -> "SchedSeq":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})
