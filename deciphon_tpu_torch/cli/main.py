"""dcp-torch command line: serve / press / scan / info / parity.

The counterpart of deciphon_tpu/cli/main.py.  ``serve`` is the
scheduler-polling worker daemon (server/daemon.py) on ``--device``
(default cuda, over every visible GPU); ``press`` and ``info`` are the
host commands; ``scan`` runs the port's engine on ``--device`` (default
cuda), with Viterbi or, under ``--forward``, forward scoring, on ACGT
reads and on reads holding IUPAC ambiguity codes, one row per hit or,
under ``--best-hit``, per read, over the whole DB or, under
``--shard i/N``, one size-balanced partition of it; a standard (typeid-1)
DB scans through ops/viterbi_standard.py on ``--device``.  ``info``
describes a .dtp, a standard DB or a reference ``.dcp``; ``parity`` runs
the reference's anchors on a .hmm with the f64 oracle, on the host.

    python -m deciphon_tpu_torch.cli.main press db.hmm -o db.dtp
    python -m deciphon_tpu_torch.cli.main scan db.dtp reads.fa -o prods.tsv
    python -m deciphon_tpu_torch.cli.main info ref.dcp
    python -m deciphon_tpu_torch.cli.main parity PF02545.hmm [ref.dcp]
    python -m deciphon_tpu_torch.cli.main serve --env .env
"""

from __future__ import annotations

import argparse
import sys

from deciphon_tpu_torch.utils import logging as log
from deciphon_tpu_torch.utils.rc import RC, DcpError


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

    # typeid dispatch (the reference's profile vtable at db-open time,
    # src/db/profile_reader.c:95-98 / src/model/profile.h:11-18)
    if db_typeid(args.db) == STANDARD:
        return _scan_standard(args)
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
    warmed = False
    batch: list[SeqRecord] = []

    def flush(batch):
        nonlocal nhits, warmed
        if not warmed:
            # library, tables and each block's first launch, at this
            # batch's shapes, before the first scan (scan_engine.warmup)
            engine.warmup(len(batch), max(len(r.data) for r in batch))
            warmed = True
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


def _scan_standard(args) -> int:
    """Scan against a standard (typeid-1, generic dense HMM) database on
    ``--device``.  Rows carry typeid 'standard' and an empty match
    column (generic profiles have no codon decode)."""
    from deciphon_tpu_torch.db.standard_db import load_standard_db
    from deciphon_tpu_torch.ops.scan_engine import resolve_device
    from deciphon_tpu_torch.ops.viterbi_standard import scan_standard
    from deciphon_tpu_torch.server.prod import ProdWriter
    from deciphon_tpu_torch.utils.fasta import read_fasta

    device = resolve_device(args.device)
    profiles = load_standard_db(args.db)
    writer = ProdWriter(
        scan_id=0,
        abc_name=profiles[0].abc.name if profiles else "dna",
        profile_typeid="standard",
    )
    nhits = nseqs = 0
    batch: list[tuple[int, str]] = []

    def flush(batch):
        nonlocal nhits
        hits = scan_standard(
            profiles, [d for _, d in batch],
            lrt_threshold=args.lrt_threshold, device=device,
        )
        for q, b, alt, null, _lrt in hits:
            writer.add(batch[q][0], profiles[b].accession, alt, null, "")
            nhits += 1

    for _, data in read_fasta(args.fasta):
        nseqs += 1
        batch.append((nseqs, data))
        if len(batch) >= args.batch_size:
            flush(batch)
            batch = []
    if batch:
        flush(batch)
    out = args.output or "prods.tsv"
    writer.write(out)
    print(f"{nhits} hits from {nseqs} seqs x {len(profiles)} profiles "
          f"on {device} -> {out}")
    return 0


# Reference anchors for the PF02545 parity run (BASELINE.md):
#   alt Viterbi loglik of the 1023-nt consensus read, profile 1
#   (reference test/protein_h3reader.c:57) and the .hmm asset's XXH3-64
#   content hash (reference test/sched.c:92).
PF02545_GOLDEN_ALT = -1430.9281381240353
PF02545_HMM_XXH3 = -7843725841264658444


def cmd_parity(args) -> int:
    """One-command reference parity runner, on the host (f64 oracle).

    Hash-checks the .hmm asset, presses it, rebuilds the consensus read,
    asserts the golden alt log-likelihood, optionally diffs structural
    press metadata against a reference-pressed .dcp, and emits the
    product TSV row for byte-diffing.  The .dcp's imm DP bins stay
    opaque (undocumented imm packing); every surrounding byte is
    checked."""
    import numpy as np

    from deciphon_tpu_torch.models import codec
    from deciphon_tpu_torch.models.alphabet import DNA, STANDARD_CODE
    from deciphon_tpu_torch.models.h3reader import press_file
    from deciphon_tpu_torch.ops import viterbi_ref as vr
    from deciphon_tpu_torch.server.prod import ProdWriter
    from deciphon_tpu_torch.utils import xfile

    failures = 0

    def check(name: str, ok: bool, detail: str = "") -> None:
        nonlocal failures
        print(f"[{'ok' if ok else 'FAIL'}] {name}"
              + (f": {detail}" if detail else ""))
        if not ok:
            failures += 1

    h = xfile.xxh3_64(args.hmm)
    known_asset = h == PF02545_HMM_XXH3
    check(
        "hmm xxh3",
        known_asset or not args.strict,
        f"{h}" + ("" if known_asset else
                  " (not the PF02545 test asset; golden checks skipped)"),
    )
    profs = list(press_file(args.hmm))
    check("press", len(profs) >= 1, f"{len(profs)} profiles")
    prof = profs[0]
    read = "".join(
        STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
        for b in np.argmax(prof.match_codonp, axis=1)
    )
    if known_asset:
        check("core_size", prof.core_size == 341, str(prof.core_size))
        check("consensus read length", len(read) == 1023, str(len(read)))
    res = vr.viterbi_alt(prof, DNA.encode(read))
    nul = vr.viterbi_null(prof, DNA.encode(read))
    print(f"     alt loglik {res.loglik:.13f}  null {nul.loglik:.13f}")
    if known_asset:
        diff = abs(res.loglik - PF02545_GOLDEN_ALT)
        check(
            "golden alt loglik (protein_h3reader.c:57)",
            diff <= args.tolerance,
            f"got {res.loglik:.13f}, want {PF02545_GOLDEN_ALT} "
            f"(|diff| {diff:.2e} <= {args.tolerance})",
        )
    if args.dcp:
        from deciphon_tpu_torch.db.dcp import read_dcp

        info = read_dcp(args.dcp)
        check("dcp profile count", info.nprofiles == len(profs),
              f"{info.nprofiles} vs {len(profs)}")
        for meta, p in zip(info.profiles, profs):
            if meta.accession != p.accession or meta.core_size != p.core_size:
                check(
                    "dcp profile metadata",
                    False,
                    f"{meta.accession}/{meta.core_size} vs "
                    f"{p.accession}/{p.core_size}",
                )
                break
        else:
            check("dcp profile metadata", True,
                  "accessions + core sizes match")
    # the product TSV row (prod.c:13-53 format) for byte-diffing
    w = ProdWriter(scan_id=0)
    match = codec.render_match(codec.match_steps(prof, read, res.path))
    w.add(1, prof.accession, res.loglik, nul.loglik, match)
    out = args.output or "parity_prods.tsv"
    w.write(out)
    print(f"     product row -> {out}")
    print("PARITY " + ("OK" if failures == 0 else f"FAILED ({failures})"))
    return 0 if failures == 0 else 1


def cmd_info(args) -> int:
    from deciphon_tpu_torch.db.dispatch import STANDARD, db_typeid
    from deciphon_tpu_torch.db.format import TensorDB

    if args.db.endswith(".dcp"):
        from deciphon_tpu_torch.db.dcp import read_dcp
        from deciphon_tpu_torch.db.dcp_dp import DcpDpError

        info = read_dcp(args.db)
        print(f"format:     reference .dcp (magic 0x{info.magic:X})")
        print(f"profiles:   {info.nprofiles}")
        print(f"type:       {info.typeid_name}")
        print(f"float_size: {info.float_size}")
        print(f"entry_dist: {info.entry_dist_name}")
        print(f"epsilon:    {info.epsilon}")
        if info.profiles:
            ks = [p.core_size for p in info.profiles]
            print(f"nodes:      {sum(ks)} (min {min(ks)}, max {max(ks)})")
        if info.profile_sizes:
            print(f"bytes/prof: min {min(info.profile_sizes)}, "
                  f"max {max(info.profile_sizes)}")
        if info.profiles:
            # invariant-driven imm_dp extraction (db/dcp_dp.py); on
            # failure the error is the analysis of which bytes block it
            try:
                _, alt = info.profiles[0].decode_dp()
                print(f"dp decode:  ok ({alt.report})")
            except DcpDpError as e:
                print(f"dp decode:  FAILED — {e}")
        return 0
    if db_typeid(args.db) == STANDARD:
        from deciphon_tpu_torch.db.standard_db import load_standard_db

        profs = load_standard_db(args.db)
        print(f"profiles:   {len(profs)}")
        print("type:       standard")
        if profs:
            print(f"abc:        {profs[0].abc.name}")
            ns = [p.nstates for p in profs]
            print(f"states:     {sum(ns)} (min {min(ns)}, max {max(ns)})")
        return 0
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

    p = sub.add_parser("scan", help="scan FASTA reads against a .dtp or "
                       "standard db")
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

    p = sub.add_parser("info", help="describe a .dtp, standard or .dcp db")
    p.add_argument("db")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "parity",
        help="run the reference parity suite on a .hmm asset "
             "(golden loglik, press metadata vs .dcp, TSV emit)",
    )
    p.add_argument("hmm", help="e.g. PF02545.hmm (the reference test asset)")
    p.add_argument("dcp", nargs="?", default="",
                   help="optional reference-pressed .dcp to diff against")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--tolerance", type=float, default=1e-3,
                   help="|diff| bound on the golden loglik (f64 oracle "
                        "vs imm accumulation order)")
    p.add_argument("--strict", action="store_true",
                   help="fail if the .hmm hash is not the known asset")
    p.set_defaults(fn=cmd_parity)

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
    except ValueError as e:
        log.error(f"{RC.EINVAL}: {e}")
        return int(RC.EINVAL)
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
