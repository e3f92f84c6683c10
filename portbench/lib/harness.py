"""One run of one cell: set-up, the measured window, metrics, the check.

Everything that belongs to a configuration, a traffic mix, a per-layer
metric or a cell is found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` (which names its driver, ``drivers/<kind>.py``),
``metrics/<quantity>.py`` (the reader of every per-layer metric named
``<quantity>`` or ``<quantity>.<qualifier>``) and
``limits/<workload>.json``, all under portbench/.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from portbench.lib import check, dbgen, devtrace, roofline
from portbench.lib.loop import run_window

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deciphon_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list  # this cell's end-to-end metrics (entries of BENCHMARK.json)
    per_layer: list

    @property
    def driver(self):
        return importlib.import_module(f"portbench.drivers.{self.mix['driver']}")


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and ("workloads" in m or m["moves"] in names)]
    return Cell(workload, cell["chips"], config, mix, limits, e2e, layer)


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<quantity>.py``,
    the quantity being the name before its first '.'."""
    quantity = name.split(".")[0]
    path = BENCH / "metrics" / f"{quantity}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + quantity, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_info() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


@dataclass
class Run:
    """What a per-layer metric's reader may read."""

    cell: Cell
    records: list
    units: list
    sizes: np.ndarray
    timeline: devtrace.Timeline | None

    def kernel_roofline(self, part: str, semiring: str) -> float | None:
        """100 x least time / device time of the kernels named ``part``
        over the traced window's units, or None with nothing to read."""
        if self.timeline is None:
            return None
        t = self.timeline.kernel_s(part)
        if t <= 0:
            return None
        cache: dict = {}
        least = 0.0
        for r in self.records:
            if r.unit not in cache:
                cache[r.unit] = roofline.least_seconds(
                    semiring, *roofline.scan_work(self.units[r.unit].reads, self.sizes))
            least += cache[r.unit]
        return 100.0 * least / t


def _jsonable(x: float) -> float:
    return float(x) if np.isfinite(x) else 1e300


def open_engine(cell: Cell, device: str, log):
    """(engine, H3 parameters, the pressed DB's files): the configuration's
    DB, pressed on a miss, loaded into a ScanEngine of its scan flags."""
    from deciphon_tpu_torch.db.format import TensorDB
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine, ScanParams

    db_cfg = dbgen.db_of(cell.config)
    prm = dbgen.h3_params(db_cfg)
    db_files = dbgen.pressed(db_cfg, prm)
    log(f"db: {len(prm.sizes)} profiles, {int(prm.off[-1])} nodes, "
        f"{db_files.dtp}; pressed in {db_files.pressed_s:.4f} s this run")
    db = TensorDB.load(str(db_files.dtp))
    return ScanEngine(db, ScanParams(**cell.config["scan"]), device=device), prm, db_files


def make_traffic(cell: Cell, prm, seed: int):
    """(pool, warm-up units, warm-up shape) from the seed, with the
    program's SeqRecords."""
    from deciphon_tpu_torch.ops.scan_engine import SeqRecord

    pool, warm, shape = cell.driver.generate(cell.mix, prm, seed)
    sid = 0
    for u in pool + warm:
        u.seqs = [SeqRecord(sid + j + 1, f"r{sid + j + 1}", s)
                  for j, s in enumerate(u.reads)]
        sid += len(u.reads)
    return pool, warm, shape


def blocks_of(engine) -> list[np.ndarray]:
    """The DB indices of each of the program's blocks (one kernel width
    each), on the host, for the check's sample."""
    return [np.asarray(b.chunk) for b in engine.blocks]


def judge_window(cell: Cell, db_files, prm, blocks, records, pool, seed: int,
                 device, log, control_dtype=None):
    """(numbers, what was compared) of the window's sample; with
    ``control_dtype`` also the control's numbers on the same sample."""
    t0 = time.perf_counter()
    ref = check.Reference(db_files.text, dbgen.db_of(cell.config), device)
    sample, out = check.choose(records, pool, prm.sizes, blocks, cell.mix["check"],
                               seed)
    nums, seen = check.judge(ref, sample, out, cell.config["scan"],
                             cell.limits["pass1_gap"])
    log(f"check: {seen} in {time.perf_counter() - t0:.4f} s")
    if control_dtype is None:
        return nums, seen
    ctl = check.Control(ref, control_dtype, cell.config["scan"],
                        cell.mix["check"]["hits"], seed)
    c_sample, c_out = ctl.output(sample)
    c_nums, c_seen = check.judge(ref, c_sample, c_out, cell.config["scan"],
                                 cell.limits["pass1_gap"])
    return nums, seen, c_nums, c_seen


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", log=print) -> dict:
    """One run; returns the result line's object.  ``t0`` is the host
    clock at process start (set-up is counted from it)."""
    import torch

    from deciphon_tpu_torch.server.prod import ProdWriter

    engine, prm, db_files = open_engine(cell, device, log)
    pool, warm, (nseqs, max_len) = make_traffic(cell, prm, seed)
    warm_s = engine.warmup(nseqs, max_len)
    for u in warm:
        engine.scan(u.seqs)
    if device != "cpu":
        torch.cuda.synchronize()
    writer = ProdWriter(scan_id=0)
    setup_s = time.perf_counter() - t0
    log(f"setup: {setup_s:.4f} s (warmup {warm_s:.4f} s); pool of "
        f"{len(pool)} units, {sum(len(u.reads) for u in pool)} reads")

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        records = run_window(engine, writer, pool, seconds, record_function)
        if device != "cpu":
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    else:
        records = run_window(engine, writer, pool, seconds)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    span = records[-1].end - records[0].start
    log(f"window: {len(records)} units in {span:.4f} s; peak device memory "
        f"{peak} B")

    timeline = devtrace.timeline(prof) if prof is not None else None
    prof = None
    run_ = Run(cell, records, pool, prm.sizes, timeline)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(run_)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = cell.driver.end_to_end(records)
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            else:  # a metric "<quantity>.<qualifier>" reports its quantity
                v = e2e.get(m["name"], e2e.get(m["name"].split(".")[0]))
                if v is not None:
                    metrics[m["name"]] = {"value": v[0], "unit": m["unit"]}

    # the TSV of the window's rows, written after it
    out_tsv = Path(tempfile.gettempdir()) / f"portbench_{cell.name}.tsv"
    writer.write(str(out_tsv))
    nrows = len(writer.rows)
    log(f"{nrows} rows -> {out_tsv}")
    blocks = blocks_of(engine)
    del engine, writer
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    nums, _ = judge_window(cell, db_files, prm, blocks, records, pool, seed, device,
                           log)
    correct = all(nums[k] <= cell.limits[k] for k in check.NUMBERS)

    found = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if found:
        raise SystemExit(f"forbidden modules loaded: {found[:10]}")

    failed = sum(r.nreads for r in records if r.failed)
    result = {
        "correct": bool(correct),
        "attempted": sum(r.nreads for r in records),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device != "cpu" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if timeline is not None:
        result["device"]["busy_s"] = timeline.busy_s
        result["device"]["window_s"] = timeline.window_s
        ops = sorted(timeline.by_name.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label, s] for s, label in timeline.gaps[:10]],
        }
    result["check"] = {k: {"value": _jsonable(nums[k]), "limit": cell.limits[k]}
                       for k in check.NUMBERS}
    return result
