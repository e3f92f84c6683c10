"""Worker daemon: poll the scheduler, claim jobs, run press/scan workloads.

The counterpart of deciphon_tpu/server/daemon.py on the port's engine:
the runtime half of the reference's dcp-server (src/server/server.c:61-100
poll loop, src/server/job.c dispatch, src/server/hmm.c press workload,
src/server/scan.c scan workload), with the scan compute on the Hopper
kernel: one card, or a [seqs, profiles] mesh over every visible GPU
when there is more than one.

What differs from the JAX daemon: there is no compile cache to warm.
The press prewarm builds the fresh DB's base-4 tables (and the kernel
library) on a background thread into the store that the first scan of
that DB then uses, and every scan joins that thread before it starts,
so a scan never races the prewarm.  Engines that differ only in
ScanParams share one table store.
"""

from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
import time

import torch

from deciphon_tpu_torch.db.format import TensorDB, write_db
from deciphon_tpu_torch.models.h3reader import count_profiles, press_file
from deciphon_tpu_torch.models.profile import ProteinCfg
from deciphon_tpu_torch.ops.scan_engine import (
    ScanEngine,
    ScanParams,
    SeqRecord,
    Tables,
    resolve_device,
)
from deciphon_tpu_torch.server.api import SchedAPI
from deciphon_tpu_torch.server.prod import ProdWriter
from deciphon_tpu_torch.server.sched import JobState, JobType, SchedJob
from deciphon_tpu_torch.utils import logging as log
from deciphon_tpu_torch.utils import xfile
from deciphon_tpu_torch.utils.config import ServerConfig
from deciphon_tpu_torch.utils.progress import Progress
from deciphon_tpu_torch.utils.rc import DcpError, EndOfData

MAX_ENGINES = 4  # bound device/host memory


class Server:
    def __init__(self, cfg: ServerConfig, api: SchedAPI | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.api = api or SchedAPI(cfg.api_url, cfg.api_key)
        self.device = resolve_device(device)  # no GPU under "cuda": raises
        self._interrupt = False
        # (path, xxh3, params) -> ScanEngine, least recently used first
        self._engines: dict[tuple, ScanEngine] = {}
        # (path, xxh3) -> the base-4 tables shared by that DB's engines
        self._tables: dict[tuple, Tables] = {}
        self._prewarm_thread: threading.Thread | None = None
        os.makedirs(cfg.cache_dir, exist_ok=True)

    # -- lifecycle ---------------------------------------------------------

    def install_signal_handler(self) -> None:
        """SIGINT drains gracefully (reference: server.c:24-33)."""

        def handler(signum, frame):
            log.info("Terminating it...")
            self._interrupt = True

        signal.signal(signal.SIGINT, handler)

    def run(self) -> None:
        """Poll loop (reference: server_run, server.c:61-100)."""
        log.info("Starting the server (%d workers)", self.cfg.num_workers)
        if self.cfg.single_run:
            self._interrupt = True
        while True:
            had_error = False
            try:
                ran = self.run_one()
                if not ran and not self._interrupt:
                    time.sleep(1.0 / self.cfg.polling_rate_hz)
            except DcpError as exc:
                log.error("job loop error: %s", exc)
                had_error = True
            if had_error and not self._interrupt:
                log.info("Backing off for %gs due to error",
                         self.cfg.error_backoff_s)
                time.sleep(self.cfg.error_backoff_s)
            if self._interrupt:
                break
        self._join_prewarm()
        log.info("Goodbye!")

    def run_one(self) -> bool:
        """Claim and run at most one job; returns True if one ran."""
        try:
            job = self.api.next_pend_job()
        except EndOfData:
            return False
        self.api.set_job_state(job.id, JobState.RUN)
        log.info("Running job[%d]", job.id)
        try:
            if job.type == JobType.HMM:
                self._press(job)
            elif job.type == JobType.SCAN:
                self._scan(job)
            else:
                raise DcpError(3, f"unknown job type {job.type}")
        except Exception as exc:  # noqa: BLE001 — job granular failure
            msg = str(exc) or type(exc).__name__
            log.error("Failed job[%d]: %s", job.id, msg)
            self.api.set_job_state(job.id, JobState.FAIL, msg[:255])
            return True
        log.info("Finished job[%d]", job.id)
        return True

    # -- workloads ---------------------------------------------------------

    def _cache_path(self, filename: str) -> str:
        return os.path.join(self.cfg.cache_dir, os.path.basename(filename))

    def _press(self, job: SchedJob) -> None:
        """Press workload (reference: hmm_press, src/server/hmm.c:120-178)."""
        hmm = self.api.get_hmm_by_job_id(job.id)
        path = self._cache_path(hmm.filename)
        xfile.ensure_local(
            path, hmm.xxh3,
            lambda p, h: self.api.download_hmm(hmm.id, p),
        )
        nprofs = count_profiles(path)
        if nprofs <= 0:
            raise DcpError(2, "failed to count profiles")

        db_path = os.path.splitext(path)[0] + ".dtp"
        progress = Progress(
            nprofs,
            callback=lambda inc: self.api.increment_job_progress(job.id, inc),
        )

        def profiles():
            for p in press_file(path, ProteinCfg()):
                yield p
                progress.consume(1)

        write_db(db_path, profiles())
        progress.finish()
        log.info("Uploading pressed file")
        self.api.upload_db(db_path)
        self.api.set_job_state(job.id, JobState.DONE)
        self._press_prewarm(db_path)

    def _press_prewarm(self, db_path: str) -> None:
        """Build the freshly pressed DB's base-4 tables (and the kernel
        library) now, on a background thread, while no scan is waiting:
        the first scan job of this DB finds them in the table store.
        ``_scan`` joins the thread before it starts, so the two never
        race."""
        self._join_prewarm()
        key = (db_path, xfile.xxh3_64(db_path))
        self._prune_tables(keep=key)
        tables = self._tables_for(*key)

        def _warm():
            try:
                if self.device.type == "cuda":
                    from deciphon_tpu_torch.ops import _build

                    _build.library()
                spent = tables.prepare()
                log.info("press prewarm: %d blocks in %.1fs",
                         len(tables.blocks), spent)
            except Exception:  # noqa: BLE001 — the scan builds on its own
                log.warning("press prewarm failed", exc_info=True)

        self._prewarm_thread = threading.Thread(
            target=_warm, name="press-prewarm", daemon=True
        )
        self._prewarm_thread.start()

    def _join_prewarm(self) -> None:
        if self._prewarm_thread is not None:
            self._prewarm_thread.join()
            self._prewarm_thread = None

    def _scan_mesh(self):
        """[seqs, profiles] mesh over every visible GPU, or None on one
        card (or the CPU).  DCP_MESH_PROFILES sets the profile axis."""
        if not hasattr(self, "_mesh"):
            n = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
            if n <= 1:
                self._mesh = None
            else:
                from deciphon_tpu_torch.parallel.mesh import make_scan_mesh

                paxis = os.environ.get("DCP_MESH_PROFILES")
                self._mesh = make_scan_mesh(
                    profile_axis=int(paxis) if paxis else None
                )
                log.info("scan mesh: %d seqs x %d profiles",
                         self._mesh.seqs, self._mesh.profiles)
        return self._mesh

    def _prune_tables(self, keep: tuple) -> None:
        """Drop the table stores that no cached engine uses, but
        ``keep``'s."""
        live = {k[:2] for k in self._engines} | {keep}
        for k in [k for k in self._tables if k not in live]:
            del self._tables[k]

    def _tables_for(self, path: str, xxh3: int) -> Tables:
        key = (path, xxh3)
        if key not in self._tables:
            self._tables[key] = Tables(
                TensorDB.load(path), self.device, self._scan_mesh()
            )
        return self._tables[key]

    def _engine(self, path: str, xxh3: int, params: ScanParams) -> ScanEngine:
        """LRU of scan engines: repeated scans of the same DB reuse the
        tables already on the device.  Engines of one DB share one table
        store, and a store goes with the last engine that uses it."""
        key = (path, xxh3, params)
        cache = self._engines
        if key not in cache:
            if len(cache) >= MAX_ENGINES:
                cache.pop(next(iter(cache)))
                self._prune_tables(keep=key[:2])
            tables = self._tables_for(path, xxh3)
            cache[key] = ScanEngine(tables.db, params, tables=tables)
        else:  # refresh LRU order
            cache[key] = cache.pop(key)
        return cache[key]

    def _scan(self, job: SchedJob) -> None:
        """Scan workload (reference: scan_run, src/server/scan.c:215-269)."""
        self._join_prewarm()
        scan = self.api.get_scan_by_job_id(job.id)
        db_meta = self.api.get_db(scan.db_id)
        path = self._cache_path(db_meta.filename)
        xfile.ensure_local(
            path, db_meta.xxh3,
            lambda p, h: self.api.download_db(db_meta.id, p),
        )
        params = ScanParams(
            multi_hits=bool(scan.multi_hits),
            hmmer3_compat=bool(scan.hmmer3_compat),
            lrt_threshold=self.cfg.scan_lrt_threshold,
        )
        engine = self._engine(path, db_meta.xxh3, params)
        db = engine.db
        # Single scheduler pass: the reads stream once into a local spool
        # file (counting as they go), then scan in bounded batches from
        # the spool, which keeps a multi-GB read set on disk, not in RAM.
        batch_size = int(os.environ.get("DCP_SCAN_BATCH", 1024))
        best_hit = os.environ.get("DCP_BEST_HIT", "") not in ("", "0")
        nseqs = 0
        with tempfile.NamedTemporaryFile(
            "w+", suffix=".seqs", delete=True
        ) as spool:
            for s in self.api.iter_scan_seqs(scan.id):
                spool.write(json.dumps(
                    {"id": s.id, "name": s.name, "data": s.data}
                ) + "\n")
                nseqs += 1
            total = nseqs * db.nprofiles
            log.info("%d tasks to run", total)
            progress = Progress(
                total,
                callback=lambda inc: self.api.increment_job_progress(
                    job.id, inc
                ),
            )
            engine.progress = progress
            engine.prepare()  # the tables, if no prewarm built them
            writer = ProdWriter(scan_id=scan.id)
            batch: list[SeqRecord] = []

            def flush(batch):
                if best_hit:
                    # one row per read, device-side argmax reduction
                    # (DCP_BEST_HIT=1; no traceback/match column)
                    for b in engine.best_hits(batch):
                        if b.lrt >= self.cfg.scan_lrt_threshold:
                            writer.add(
                                b.seq_id, b.accession, b.alt_loglik,
                                b.null_loglik, "",
                            )
                    return
                for h in engine.scan(batch):
                    writer.add(
                        h.seq_id, h.accession, h.alt_loglik, h.null_loglik,
                        h.match,
                    )

            spool.seek(0)
            for line in spool:
                s = json.loads(line)
                batch.append(SeqRecord(s["id"], s["name"], s["data"]))
                if len(batch) >= batch_size:
                    flush(batch)
                    batch = []
            if batch:
                flush(batch)
        progress.finish()
        with tempfile.NamedTemporaryFile(
            "w", suffix=".tsv", delete=False
        ) as fp:
            fp.write(writer.render())
            prods_path = fp.name
        try:
            self.api.upload_prods_file(prods_path)
        finally:
            os.unlink(prods_path)
        self.api.set_job_state(job.id, JobState.DONE)
