"""In-process deciphon-sched scheduler for tests and local runs.

A real HTTP server (so the actual REST client code paths are exercised)
implementing the slice of the deciphon-sched API the worker uses
(include/deciphon/sched/api.h:49-80), plus the submission endpoints tests
need to enqueue work (POST /scans/).  The reference has no such fake — its
scheduler tests require a live service and are disabled
(test/CMakeLists.txt:61); this fills that gap (SURVEY.md §4).

Protocol details mirrored from src/sched/api.c: error envelope {rc, msg};
404 + rc=5 for "no pending job"; 404 + rc=7 for "no more sequences";
201 + [] on product upload.
"""

from __future__ import annotations

import io
import json
import os
import re
import tempfile
import threading
from dataclasses import asdict, dataclass, field
from email.parser import BytesParser
from email.policy import default as default_policy
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from deciphon_tpu_torch.server.sched import (
    JobType,
    SchedDb,
    SchedHmm,
    SchedJob,
    SchedScan,
    SchedSeq,
)
from deciphon_tpu_torch.utils import xfile


class FakeScheduler:
    """Owns the scheduler state; serve() runs the HTTP facade."""

    def __init__(self, spool_dir: str | None = None):
        self.spool = spool_dir or tempfile.mkdtemp(prefix="dcp-sched-")
        os.makedirs(self.spool, exist_ok=True)
        self.lock = threading.RLock()
        self.jobs: dict[int, SchedJob] = {}
        self.hmms: dict[int, SchedHmm] = {}
        self.dbs: dict[int, SchedDb] = {}
        self.scans: dict[int, SchedScan] = {}
        self.seqs: dict[int, list[SchedSeq]] = {}  # scan_id -> seqs
        self.products: list[str] = []  # uploaded TSV payloads
        self.files: dict[str, str] = {}  # filename -> spool path
        self._next = {"job": 0, "hmm": 0, "db": 0, "scan": 0, "seq": 0}
        self._server: ThreadingHTTPServer | None = None

    # -- state helpers -----------------------------------------------------

    def _nid(self, kind: str) -> int:
        self._next[kind] += 1
        return self._next[kind]

    def _store_file(self, filename: str, content: bytes) -> tuple[str, int]:
        path = os.path.join(self.spool, os.path.basename(filename))
        with open(path, "wb") as fp:
            fp.write(content)
        self.files[os.path.basename(filename)] = path
        return path, xfile.xxh3_64(path)

    def add_hmm(self, filename: str, content: bytes) -> SchedHmm:
        with self.lock:
            path, h = self._store_file(filename, content)
            job = SchedJob(id=self._nid("job"), type=int(JobType.HMM))
            self.jobs[job.id] = job
            hmm = SchedHmm(
                id=self._nid("hmm"),
                xxh3=h,
                filename=os.path.basename(filename),
                job_id=job.id,
            )
            self.hmms[hmm.id] = hmm
            return hmm

    def add_db(self, filename: str, content: bytes) -> SchedDb:
        with self.lock:
            path, h = self._store_file(filename, content)
            db = SchedDb(
                id=self._nid("db"),
                xxh3=h,
                filename=os.path.basename(filename),
            )
            self.dbs[db.id] = db
            return db

    def add_scan(
        self,
        db_id: int,
        seqs: list[tuple[str, str]],
        multi_hits: bool = True,
        hmmer3_compat: bool = False,
    ) -> SchedScan:
        with self.lock:
            job = SchedJob(id=self._nid("job"), type=int(JobType.SCAN))
            self.jobs[job.id] = job
            scan = SchedScan(
                id=self._nid("scan"),
                db_id=db_id,
                multi_hits=multi_hits,
                hmmer3_compat=hmmer3_compat,
                job_id=job.id,
            )
            self.scans[scan.id] = scan
            self.seqs[scan.id] = [
                SchedSeq(
                    id=self._nid("seq"), scan_id=scan.id, name=n, data=d
                )
                for n, d in seqs
            ]
            return scan

    def wipe(self) -> None:
        with self.lock:
            self.jobs.clear()
            self.hmms.clear()
            self.dbs.clear()
            self.scans.clear()
            self.seqs.clear()
            self.products.clear()

    # -- http facade -------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> str:
        sched = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body) -> None:
                payload = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _send_file(self, path: str) -> None:
                with open(path, "rb") as fp:
                    data = fp.read()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "application/octet-stream"
                )
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n)

            def _multipart_file(self) -> tuple[str, bytes]:
                raw = (
                    f"Content-Type: {self.headers['Content-Type']}\r\n"
                    "\r\n"
                ).encode() + self._body()
                msg = BytesParser(policy=default_policy).parsebytes(raw)
                for part in msg.iter_parts():
                    fn = part.get_filename()
                    if fn:
                        return fn, part.get_payload(decode=True)
                raise ValueError("no file part")

            # GET ---------------------------------------------------------
            def do_GET(self):  # noqa: N802
                p = self.path
                with sched.lock:
                    if p == "/":
                        return self._send(200, {})
                    m = re.fullmatch(r"/jobs/next_pend", p)
                    if m:
                        for job in sched.jobs.values():
                            if job.state == "pend":
                                return self._send(200, asdict(job))
                        return self._send(
                            404, {"rc": 5, "msg": "no pending job"}
                        )
                    m = re.fullmatch(r"/jobs/(\d+)/hmm", p)
                    if m:
                        jid = int(m.group(1))
                        for h in sched.hmms.values():
                            if h.job_id == jid:
                                return self._send(200, asdict(h))
                        return self._send(404, {"rc": 1, "msg": "no hmm"})
                    m = re.fullmatch(r"/jobs/(\d+)/scan", p)
                    if m:
                        jid = int(m.group(1))
                        for s in sched.scans.values():
                            if s.job_id == jid:
                                return self._send(200, asdict(s))
                        return self._send(404, {"rc": 1, "msg": "no scan"})
                    m = re.fullmatch(r"/hmms/(\d+)", p)
                    if m:
                        h = sched.hmms.get(int(m.group(1)))
                        if h:
                            return self._send(200, asdict(h))
                        return self._send(404, {"rc": 1, "msg": "no hmm"})
                    m = re.fullmatch(r"/dbs/(\d+)", p)
                    if m:
                        d = sched.dbs.get(int(m.group(1)))
                        if d:
                            return self._send(200, asdict(d))
                        return self._send(404, {"rc": 1, "msg": "no db"})
                    m = re.fullmatch(r"/(hmms|dbs)/(\d+)/download", p)
                    if m:
                        store = (
                            sched.hmms if m.group(1) == "hmms" else sched.dbs
                        )
                        rec = store.get(int(m.group(2)))
                        if rec and rec.filename in sched.files:
                            return self._send_file(
                                sched.files[rec.filename]
                            )
                        return self._send(404, {"rc": 1, "msg": "no file"})
                    m = re.fullmatch(r"/scans/(\d+)/seqs/next/(\d+)", p)
                    if m:
                        sid, cursor = int(m.group(1)), int(m.group(2))
                        for seq in sched.seqs.get(sid, []):
                            if seq.id > cursor:
                                return self._send(200, asdict(seq))
                        return self._send(
                            404, {"rc": 7, "msg": "no more sequences"}
                        )
                return self._send(404, {"rc": 1, "msg": "unknown path"})

            # PATCH -------------------------------------------------------
            def do_PATCH(self):  # noqa: N802
                p = self.path
                body = json.loads(self._body() or b"{}")
                with sched.lock:
                    m = re.fullmatch(r"/jobs/(\d+)/state", p)
                    if m:
                        job = sched.jobs.get(int(m.group(1)))
                        if not job:
                            return self._send(
                                404, {"rc": 1, "msg": "no job"}
                            )
                        job.state = body.get("state", job.state)
                        job.error = body.get("error", "")
                        return self._send(200, asdict(job))
                    m = re.fullmatch(r"/jobs/(\d+)/progress", p)
                    if m:
                        job = sched.jobs.get(int(m.group(1)))
                        if not job:
                            return self._send(
                                404, {"rc": 1, "msg": "no job"}
                            )
                        job.progress = min(
                            100, job.progress + int(body.get("increment", 0))
                        )
                        return self._send(200, asdict(job))
                return self._send(404, {"rc": 1, "msg": "unknown path"})

            # POST --------------------------------------------------------
            def do_POST(self):  # noqa: N802
                p = self.path
                if p == "/hmms/":
                    fn, content = self._multipart_file()
                    hmm = sched.add_hmm(fn, content)
                    return self._send(201, asdict(hmm))
                if p == "/dbs/":
                    fn, content = self._multipart_file()
                    db = sched.add_db(fn, content)
                    return self._send(201, asdict(db))
                if p == "/prods/":
                    fn, content = self._multipart_file()
                    with sched.lock:
                        sched.products.append(content.decode())
                    return self._send(201, [])
                if p == "/scans/":
                    body = json.loads(self._body() or b"{}")
                    scan = sched.add_scan(
                        body["db_id"],
                        [(s["name"], s["data"]) for s in body.get("seqs", [])],
                        body.get("multi_hits", True),
                        body.get("hmmer3_compat", False),
                    )
                    return self._send(201, asdict(scan))
                return self._send(404, {"rc": 1, "msg": "unknown path"})

            # DELETE ------------------------------------------------------
            def do_DELETE(self):  # noqa: N802
                if self.path == "/sched/wipe":
                    sched.wipe()
                    return self._send(200, {})
                return self._send(404, {"rc": 1, "msg": "unknown path"})

        self._server = ThreadingHTTPServer((host, port), Handler)
        thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        thread.start()
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def shutdown(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
