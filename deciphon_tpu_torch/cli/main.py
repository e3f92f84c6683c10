"""dcp-torch command line: press / scan / info.

The counterpart of deciphon_tpu/cli/main.py for the scan path.  ``press``
and ``info`` are the shared host commands of the JAX package (they import
no jax); ``scan`` runs the port's engine on ``--device`` (default cuda),
with Viterbi or, under ``--forward``, forward scoring, on ACGT reads and
on reads holding IUPAC ambiguity codes.  The daemon (``serve``),
``--best-hit``, ``--shard``, ``parity`` and standard (typeid-1)
databases are later slices of the port (ROADMAP.md).

    python -m deciphon_tpu_torch.cli.main press db.hmm -o db.dtp
    python -m deciphon_tpu_torch.cli.main scan db.dtp reads.fa -o prods.tsv
"""

from __future__ import annotations

import argparse
import sys

from deciphon_tpu.cli.main import cmd_info, cmd_press
from deciphon_tpu.utils import logging as log
from deciphon_tpu.utils.rc import RC, DcpError


def cmd_scan(args) -> int:
    from deciphon_tpu.db.dispatch import STANDARD, db_typeid
    from deciphon_tpu.db.format import TensorDB
    from deciphon_tpu.server.prod import ProdWriter
    from deciphon_tpu.utils.fasta import read_fasta
    from deciphon_tpu_torch.ops.scan_engine import (
        ScanEngine, ScanParams, SeqRecord,
    )

    if db_typeid(args.db) == STANDARD:
        raise NotImplementedError(
            "standard (typeid-1) databases are not ported to "
            "deciphon_tpu_torch yet (ROADMAP.md, queue 1)"
        )
    db = TensorDB.load(args.db)
    engine = ScanEngine(
        db,
        ScanParams(
            multi_hits=not args.no_multi_hits,
            hmmer3_compat=args.hmmer3_compat,
            lrt_threshold=args.lrt_threshold,
            algo="forward" if args.forward else "viterbi",
        ),
        device=args.device,
    )
    # bounded batches, as the reference streams the FASTA
    writer = ProdWriter(scan_id=0)
    nhits = nseqs = 0
    batch: list[SeqRecord] = []

    def flush(batch):
        nonlocal nhits
        for h in engine.scan(batch):
            writer.add(
                h.seq_id, h.accession, h.alt_loglik, h.null_loglik, h.match
            )
            nhits += 1

    for name, data in read_fasta(args.fasta):
        nseqs += 1
        batch.append(SeqRecord(nseqs, name, data))
        if len(batch) >= args.batch_size:
            flush(batch)
            batch = []
    if batch:
        flush(batch)
    out = args.output or "prods.tsv"
    writer.write(out)
    print(f"{nhits} hits from {nseqs} seqs x {db.nprofiles} profiles "
          f"on {engine.device} -> {out}")
    return 0


def main(argv=None) -> int:
    log.setup()
    ap = argparse.ArgumentParser(prog="dcp-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("press", help="compile a HMMER3 .hmm into a .dtp db")
    p.add_argument("hmm")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--epsilon", type=float, default=0.01)
    p.add_argument("--uniform-entry", action="store_true")
    p.set_defaults(fn=cmd_press)

    p = sub.add_parser("scan", help="scan FASTA reads against a .dtp db")
    p.add_argument("db")
    p.add_argument("fasta")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--lrt-threshold", type=float, default=10.0)
    p.add_argument("--no-multi-hits", action="store_true")
    p.add_argument("--hmmer3-compat", action="store_true")
    p.add_argument(
        "--batch-size", type=int, default=1024,
        help="reads scanned per device batch (memory bound)",
    )
    p.add_argument(
        "--forward", action="store_true",
        help="score with the forward algorithm (logsumexp over all "
             "paths) instead of Viterbi: logliks/LRT measure total path "
             "mass; match strings still decode the Viterbi path",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (the kernel; raises without a GPU) or cpu",
    )
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser("info", help="describe a .dtp database")
    p.add_argument("db")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    # error boundary as in the reference CLI: user-level failures become
    # one log line + exit code
    try:
        return args.fn(args)
    except DcpError as e:
        log.error(str(e))
        return int(e.rc) or 1
    except (FileNotFoundError, IsADirectoryError, PermissionError) as e:
        log.error(f"{RC.EIO}: {e}")
        return int(RC.EIO)
    except (ValueError, NotImplementedError) as e:
        log.error(f"{RC.EINVAL}: {e}")
        return int(RC.EINVAL)
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
