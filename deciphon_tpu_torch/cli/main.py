"""dcp-torch command line: serve / press / scan / info.

The counterpart of deciphon_tpu/cli/main.py.  ``serve`` is the
scheduler-polling worker daemon (server/daemon.py) on ``--device``
(default cuda, over every visible GPU); ``press`` and ``info`` are the
host commands; ``scan`` runs the port's engine on ``--device`` (default
cuda), with Viterbi or, under ``--forward``, forward scoring, on ACGT
reads and on reads holding IUPAC ambiguity codes, one row per hit or,
under ``--best-hit``, per read, over the whole DB or, under
``--shard i/N``, one size-balanced partition of it.  ``parity``,
reference ``.dcp`` files and standard (typeid-1) databases are later
slices of the port (ROADMAP.md).

    python -m deciphon_tpu_torch.cli.main press db.hmm -o db.dtp
    python -m deciphon_tpu_torch.cli.main scan db.dtp reads.fa -o prods.tsv
    python -m deciphon_tpu_torch.cli.main serve --env .env
"""

from __future__ import annotations

import argparse
import sys

from deciphon_tpu_torch.utils import logging as log
from deciphon_tpu_torch.utils.rc import RC, DcpError

NO_STANDARD = (
    "standard (typeid-1) databases are not ported to "
    "deciphon_tpu_torch yet (ROADMAP.md, queue 1)"
)


def cmd_serve(args) -> int:
    from deciphon_tpu_torch.server.daemon import Server
    from deciphon_tpu_torch.utils.config import ServerConfig

    cfg = ServerConfig.from_env(args.env)
    cfg.single_run = args.single_run
    if args.cache_dir:
        cfg.cache_dir = args.cache_dir
    server = Server(cfg, device=args.device)
    server.install_signal_handler()
    server.run()
    return 0


def cmd_press(args) -> int:
    from deciphon_tpu_torch.db.format import write_db
    from deciphon_tpu_torch.models.h3reader import press_file
    from deciphon_tpu_torch.models.profile import (
        ENTRY_DIST_OCCUPANCY,
        ENTRY_DIST_UNIFORM,
        ProteinCfg,
    )

    out = args.output or args.hmm.rsplit(".", 1)[0] + ".dtp"
    cfg = ProteinCfg(
        entry_dist=(
            ENTRY_DIST_UNIFORM if args.uniform_entry else ENTRY_DIST_OCCUPANCY
        ),
        epsilon=args.epsilon,
    )
    n = 0

    def gen():
        nonlocal n
        for p in press_file(args.hmm, cfg):
            n += 1
            if n % 100 == 0:
                log.info("pressed %d profiles", n)
            yield p

    write_db(out, gen())
    print(f"pressed {n} profiles -> {out}")
    return 0


def cmd_scan(args) -> int:
    from deciphon_tpu_torch.db.dispatch import STANDARD, db_typeid
    from deciphon_tpu_torch.db.format import TensorDB
    from deciphon_tpu_torch.ops.scan_engine import (
        ScanEngine, ScanParams, SeqRecord,
    )
    from deciphon_tpu_torch.server.prod import ProdWriter
    from deciphon_tpu_torch.utils.fasta import read_fasta

    if db_typeid(args.db) == STANDARD:
        raise NotImplementedError(NO_STANDARD)
    db = TensorDB.load(args.db)
    subset = None
    nprofiles = db.nprofiles
    if args.shard:
        # share-nothing scale-out: worker i of N scans one contiguous
        # size-balanced DB partition (src/db/profile_reader.c:44-72)
        from deciphon_tpu_torch.db.partition import balanced_partitions

        i, n = (int(x) for x in args.shard.split("/", 1))
        if not 1 <= i <= n:
            raise ValueError(f"--shard {args.shard}: need 1 <= i <= N")
        subset = list(balanced_partitions(db.profile_weights(), n)[i - 1])
        nprofiles = len(subset)
    engine = ScanEngine(
        db,
        ScanParams(
            multi_hits=not args.no_multi_hits,
            hmmer3_compat=args.hmmer3_compat,
            lrt_threshold=args.lrt_threshold,
            algo="forward" if args.forward else "viterbi",
        ),
        device=args.device,
        subset=subset,
    )
    # bounded batches, as the reference streams the FASTA
    writer = ProdWriter(scan_id=0)
    nhits = nseqs = 0
    batch: list[SeqRecord] = []

    def flush(batch):
        nonlocal nhits
        if args.best_hit:
            # one row per read: the device-side argmax reduction; no
            # traceback, so no match column
            for b in engine.best_hits(batch):
                if b.lrt >= args.lrt_threshold:
                    writer.add(b.seq_id, b.accession, b.alt_loglik,
                               b.null_loglik, "")
                    nhits += 1
            return
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
    shard = f" (shard {args.shard})" if args.shard else ""
    print(f"{nhits} hits from {nseqs} seqs x {nprofiles} profiles{shard} "
          f"on {engine.device} -> {out}")
    return 0


def cmd_info(args) -> int:
    from deciphon_tpu_torch.db.dispatch import STANDARD, db_typeid
    from deciphon_tpu_torch.db.format import TensorDB

    if args.db.endswith(".dcp"):
        raise NotImplementedError(
            "reference .dcp files are not ported to deciphon_tpu_torch "
            "yet (ROADMAP.md, queue 1)"
        )
    if db_typeid(args.db) == STANDARD:
        raise NotImplementedError(NO_STANDARD)
    db = TensorDB.load(args.db)
    h = db.header
    print(f"profiles:   {db.nprofiles}")
    print(f"type:       {h['profile_typeid']}")
    print(f"entry_dist: {h['entry_dist']}")
    print(f"epsilon:    {h['epsilon']}")
    print(f"nodes:      {int(db.core_sizes.sum())} "
          f"(min {int(db.core_sizes.min())}, "
          f"max {int(db.core_sizes.max())})")
    return 0


def main(argv=None) -> int:
    log.setup()
    ap = argparse.ArgumentParser(prog="dcp-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="run the scheduler-polling worker")
    p.add_argument("--env", default=".env")
    p.add_argument("--cache-dir", default="")
    p.add_argument("--single-run", action="store_true")
    p.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (every visible GPU; raises without "
             "one) or cpu",
    )
    p.set_defaults(fn=cmd_serve)

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
        "--shard", default="",
        help="i/N: scan only the i-th of N size-balanced DB partitions "
             "(share-nothing scale-out; run N workers, merge TSVs)",
    )
    p.add_argument(
        "--best-hit", action="store_true",
        help="emit one row per read (its best LRT-passing profile) via "
             "the device-side argmax reduction; no match column",
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
