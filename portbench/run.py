"""The port's benchmark: one run of one cell.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell named in BENCHMARK.json once on the CUDA card: set-up
(the pressed DB from portbench/cache/, the engine, its warm-up at the
cell's shapes), a closed loop for ``--seconds``, then the check of a
sample of the window's outputs against the plain reference.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics from a torch.profiler trace of the
window), ``device`` and last ``check``, each number compared with its
limit; the same numbers are the last lines of standard error.  Exits
non-zero, printing no result, without a CUDA card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.pop("DCP_PROFILE_DIR", None)  # the window is traced here
    os.environ["USE_FLAX"] = "0"
    cache = ROOT / "portbench" / "cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    from portbench.lib import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
        return 3

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"card: {harness.card_info()}; torch {torch.__version__}")
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), T0,
                         "cuda", log)
    for k, v in result["check"].items():
        log(f"check {k}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
