"""Readings for the limits of a cell's check, in one process.

    python portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --seconds <s> [--control-seeds 1,2,3]

Sets the cell up once, then for each seed makes its traffic, runs a
window of ``--seconds`` and judges the window's sample against the
reference (the program's readings); for each control seed it also puts
the reference in the program's place, computed in bfloat16 (the
nearest precision below the configurations' float32), on the same
sample (the control's readings).  One JSON line
a seed, then the largest program reading and the smallest control
reading of each number.  Like run.py, it exits non-zero, printing no
reading, without a CUDA card: readings of the CPU path are no cell's.
"""

import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from deciphon_tpu_torch.server.prod import ProdWriter
    from portbench.lib import check, harness
    from portbench.lib.loop import run_window

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"cuda available: {torch.cuda.is_available()}")
        return 3
    dev = "cuda"
    log(f"card: {harness.card_info()}")
    engine, prm, db_files = harness.open_engine(cell, dev, log)
    blocks = harness.blocks_of(engine)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    dtype = torch.bfloat16
    worst, least = {}, {}
    for n, seed in enumerate(seeds):
        pool, warm, shape = harness.make_traffic(cell, prm, seed)
        if n == 0:
            engine.warmup(*shape)
            for u in warm:
                engine.scan(u.seqs)
        records = run_window(engine, ProdWriter(), pool, args.seconds)
        res = harness.judge_window(cell, db_files, prm, blocks, records, pool, seed,
                                   dev, log, dtype if seed in ctl else None)
        line = {"seed": seed, "units": len(records), "program": res[0], "seen": res[1]}
        for k in check.NUMBERS:
            worst[k] = max(worst.get(k, 0), res[0][k])
        if seed in ctl:
            line["control"], line["control_seen"] = res[2], res[3]
            for k in check.NUMBERS:
                least[k] = min(least.get(k, float("inf")), res[2][k])
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "program_max": worst,
                      "control_min": least, "seconds": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
