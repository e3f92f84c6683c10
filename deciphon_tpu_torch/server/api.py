"""REST client for the deciphon-sched scheduler service.

Covers the reference's full api surface (include/deciphon/sched/api.h:49-80,
src/sched/api.c) with the same endpoints, error-envelope protocol
({rc, msg}; rc==5 on /jobs/next_pend means "no pending job", rc==7 on
/scans/.../seqs/next/... means "no more sequences" — both map to EndOfData,
the reference's RC_END), the X-API-KEY header (xcurl.c:52-88), and the
reference's 5s connect / long transfer timeouts (xcurl.c:23-24).  A lock
serializes calls like the reference's global OpenMP lock (api.c:17).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import requests

from deciphon_tpu_torch.utils import trace
from deciphon_tpu_torch.server.sched import (
    JobState,
    SchedDb,
    SchedHmm,
    SchedJob,
    SchedScan,
    SchedSeq,
)
from deciphon_tpu_torch.utils.rc import RC, DcpError, EndOfData

CONNECT_TIMEOUT_S = 5.0
TRANSFER_TIMEOUT_S = 3000.0

_IDLE_RC = 5  # no pending job
_END_RC = 7  # no more sequences


class SchedAPI:
    def __init__(self, url_stem: str, api_key: str = ""):
        self.url = url_stem.rstrip("/")
        self.session = requests.Session()
        if api_key:
            self.session.headers["X-API-KEY"] = api_key
        self._lock = threading.Lock()

    # -- plumbing ----------------------------------------------------------

    def _request(self, method: str, path: str, **kw):
        kw.setdefault("timeout", (CONNECT_TIMEOUT_S, TRANSFER_TIMEOUT_S))
        with self._lock:
            try:
                resp = self.session.request(method, self.url + path, **kw)
            except requests.RequestException as exc:
                raise DcpError(RC.EHTTP, f"{method} {path}: {exc}") from exc
        if trace.http_debug_enabled():
            trace.log_http(
                method, path, resp.status_code,
                len(resp.request.body or b"")
                if resp.request is not None else 0,
                len(resp.content),
            )
        return resp

    @staticmethod
    def _envelope(resp, end_rc: int | None = None) -> dict:
        """Decode a response, raising the reference's error taxonomy."""
        try:
            body = resp.json()
        except ValueError as exc:
            raise DcpError(
                RC.EPARSE, f"bad scheduler response ({resp.status_code})"
            ) from exc
        if resp.status_code in (200, 201):
            return body
        if isinstance(body, dict) and "rc" in body:
            if end_rc is not None and body.get("rc") == end_rc:
                raise EndOfData()
            raise DcpError(RC.EAPI, body.get("msg", ""))
        raise DcpError(RC.EHTTP, f"HTTP {resp.status_code}")

    # -- service -----------------------------------------------------------

    def is_reachable(self) -> bool:
        try:
            return self._request("GET", "/").status_code == 200
        except DcpError:
            return False

    def wipe(self) -> None:
        self._envelope(self._request("DELETE", "/sched/wipe"))

    # -- jobs --------------------------------------------------------------

    def next_pend_job(self) -> SchedJob:
        """GET /jobs/next_pend; raises EndOfData when the queue is idle."""
        resp = self._request("GET", "/jobs/next_pend")
        return SchedJob.from_json(self._envelope(resp, end_rc=_IDLE_RC))

    def set_job_state(
        self, job_id: int, state: JobState, error: str = ""
    ) -> None:
        resp = self._request(
            "PATCH",
            f"/jobs/{job_id}/state",
            json={"job_id": job_id, "state": state.value, "error": error},
        )
        self._envelope(resp)

    def increment_job_progress(self, job_id: int, increment: int) -> None:
        resp = self._request(
            "PATCH",
            f"/jobs/{job_id}/progress",
            json={"increment": int(increment)},
        )
        self._envelope(resp)

    # -- hmm ---------------------------------------------------------------

    def upload_hmm(self, filepath: str) -> SchedHmm:
        with open(filepath, "rb") as fp:
            resp = self._request(
                "POST", "/hmms/",
                files={"hmm_file": (filepath, fp, "text/plain")},
            )
        return SchedHmm.from_json(self._envelope(resp))

    def get_hmm(self, hmm_id: int) -> SchedHmm:
        resp = self._request("GET", f"/hmms/{hmm_id}")
        return SchedHmm.from_json(self._envelope(resp))

    def get_hmm_by_job_id(self, job_id: int) -> SchedHmm:
        resp = self._request("GET", f"/jobs/{job_id}/hmm")
        return SchedHmm.from_json(self._envelope(resp))

    def download_hmm(self, hmm_id: int, dest_path: str) -> str:
        return self._download(f"/hmms/{hmm_id}/download", dest_path)

    # -- db ----------------------------------------------------------------

    def upload_db(self, filepath: str) -> SchedDb:
        with open(filepath, "rb") as fp:
            resp = self._request(
                "POST", "/dbs/",
                files={
                    "db_file": (filepath, fp, "application/octet-stream")
                },
            )
        return SchedDb.from_json(self._envelope(resp))

    def get_db(self, db_id: int) -> SchedDb:
        resp = self._request("GET", f"/dbs/{db_id}")
        return SchedDb.from_json(self._envelope(resp))

    def download_db(self, db_id: int, dest_path: str) -> str:
        return self._download(f"/dbs/{db_id}/download", dest_path)

    # -- scans -------------------------------------------------------------

    def get_scan_by_job_id(self, job_id: int) -> SchedScan:
        resp = self._request("GET", f"/jobs/{job_id}/scan")
        return SchedScan.from_json(self._envelope(resp))

    def scan_next_seq(self, scan_id: int, seq_id: int) -> SchedSeq:
        """Cursor-style iteration; raises EndOfData past the last one."""
        resp = self._request(
            "GET", f"/scans/{scan_id}/seqs/next/{seq_id}"
        )
        return SchedSeq.from_json(self._envelope(resp, end_rc=_END_RC))

    def iter_scan_seqs(self, scan_id: int):
        """Stream sequences one at a time off the scheduler cursor (the
        reference's per-seq fetch loop, scan.c:227 + api.c:421-432)."""
        cursor = 0
        while True:
            try:
                seq = self.scan_next_seq(scan_id, cursor)
            except EndOfData:
                return
            yield seq
            cursor = seq.id

    def scan_seqs(self, scan_id: int) -> list[SchedSeq]:
        """Drain the sequence cursor (the reference counts them the same
        way, api.c:470-485)."""
        return list(self.iter_scan_seqs(scan_id))

    def scan_num_seqs(self, scan_id: int) -> int:
        n = 0
        for _ in self.iter_scan_seqs(scan_id):
            n += 1
        return n

    # -- products ----------------------------------------------------------

    def upload_prods_file(self, filepath: str) -> None:
        with open(filepath, "rb") as fp:
            resp = self._request(
                "POST", "/prods/",
                files={
                    "prods_file": (
                        "prods_file.tsv", fp, "text/tab-separated-values"
                    )
                },
            )
        self._envelope(resp)

    # -- helpers -----------------------------------------------------------

    def _download(self, path: str, dest_path: str) -> str:
        resp = self._request("GET", path, stream=True)
        if resp.status_code != 200:
            self._envelope(resp)
        with open(dest_path, "wb") as fp:
            for chunk in resp.iter_content(1 << 20):
                fp.write(chunk)
        return dest_path
