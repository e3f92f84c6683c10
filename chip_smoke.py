#!/usr/bin/env python3
"""On-card smoke test of the deciphon_tpu_torch scan path (one NVIDIA GPU).

    python3 chip_smoke.py    # needs one CUDA card; ~100 s on an H100

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit) and the kernel build
     (nvcc, sm_90a) from csrc/ in this checkout;
  2. the Viterbi kernel against its plain torch version on the card, over
     a menu of core sizes, read lengths and flags, every cell within
     1e-4 + 1e-6 * |plain|;
  3. the main path at a Pfam-shaped size: press a synthetic 1024-profile
     .hmm and scan 256 reads with the port's CLI (subprocesses), then the
     same engine in process: planted reads must hit their profiles, the
     kernel must have been launched, every pass-1 cell must equal the
     plain version, and no jax may be loaded.  Warm scan seconds, GCUPS
     and kernel-vs-plain times are timed with CUDA events.
The last two lines are the card line and a JSON {"ok": true, ...}; the
line before them is the JSON kernel table.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

TOL_ABS, TOL_REL = 1e-4, 1e-6  # both sides f32, same additions; only
# the order of the max-reductions over K and of the scan differs
KERNEL_SOURCE = "deciphon_tpu_torch/csrc/viterbi.cu"
KERNEL_REPLACES = "deciphon_tpu/ops/viterbi_pallas.py:178"
MENU_K = (8, 129, 768, 896, 1536, 2048, 4096)
MENU_LENS = (0, 1, 2, 4, 5, 27, 254, 255, 256, 600)  # 0: a padding row
FLAGS = ((True, False), (False, False), (True, True), (False, True))
NPROF = 1024
NREADS = 256
NPLANTED = 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def max_excess(got, want) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| - tolerance)."""
    d = (got - want).abs()
    return float(d.max()), float((d - (TOL_ABS + TOL_REL * want.abs())).max())


def eidx_of(reads, pad_to: int):
    from deciphon_tpu.models.alphabet import DNA
    from deciphon_tpu.ops.emissions import fragment_indices
    from deciphon_tpu_torch.ops.viterbi_torch import end_fragment_indices

    return np.stack([
        end_fragment_indices(fragment_indices(DNA.encode(r), pad_to=pad_to))
        for r in reads
    ])


def phase_kernel_menu(dev) -> float:
    import torch

    from deciphon_tpu.models.profile import sample_profile
    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops.viterbi_torch import NEG

    rng = np.random.default_rng(7)
    reads = ["".join(rng.choice(list("ACGT"), n)) for n in MENU_LENS]
    eidx = torch.from_numpy(eidx_of(reads, max(MENU_LENS))).to(dev)
    slen = torch.tensor(MENU_LENS, dtype=torch.int32, device=dev)
    worst = -1.0
    for K in MENU_K:
        # ragged block: cores below the padded width leave padding nodes;
        # the last profile repeats the widest with two dead DD links
        # inside its core (the -1e4 clamp of the telescoped D-chain)
        cores = sorted({K, max(2, K - 5), max(2, K // 2), max(2, K // 3)})
        profiles = [
            sample_profile(100 * K + j, k) for j, k in enumerate(cores)
        ]
        dd = profiles[-1].dd_in.copy()
        dd[[K // 3, 2 * K // 3]] = -np.inf
        profiles.append(replace(profiles[-1], dd_in=dd))
        blk = vc.CudaBlock.from_profiles(profiles, device=dev)
        for mh, h3 in FLAGS:
            alt, null = vc.scores(blk, eidx, slen, mh, h3)
            palt, pnull = vc.scores_plain(blk, eidx, slen, mh, h3)
            torch.cuda.synchronize()
            da, ea = max_excess(alt, palt)
            dn, en = max_excess(null, pnull)
            finite = bool(torch.isfinite(alt[1:]).all() and
                          torch.isfinite(null[1:]).all())
            pad_row = bool((alt[0] == NEG).all() and (null[0] == NEG).all())
            print(f"menu K={K} kpad={blk.kpad} cores={cores} "
                  f"multi_hits={mh} hmmer3_compat={h3}: "
                  f"max|d| alt {da:.3g} null {dn:.3g}")
            # per-length detail: the deltas of each read row
            per = (alt - palt).abs().amax(1).tolist()
            print("  per read length: " + " ".join(
                f"{n}:{d:.2g}" for n, d in zip(MENU_LENS, per)))
            if not (finite and pad_row) or max(ea, en) > 0:
                raise SystemExit(f"kernel disagrees with plain at K={K}")
            worst = max(worst, da, dn)
    print(f"menu: all {len(MENU_K) * len(FLAGS)} cells within tolerance, "
          f"max|d| {worst:.3g}")
    return worst


def ragged_core_sizes(rng) -> np.ndarray:
    """bench.py's Pfam-like draw (bench.py:201-209): lognormal, median
    150, sigma 0.8, clipped to 16..4096, plus 1024/2048/4096 outliers."""
    tail = [1024, 2048, 4096]
    sizes = np.exp(rng.normal(np.log(150.0), 0.8, NPROF - len(tail)))
    sizes = np.clip(sizes, 16, 4096).astype(np.int64)
    return np.concatenate([sizes, tail]).astype(np.int64)


def consensus_dna(prof) -> str:
    from deciphon_tpu.models.alphabet import STANDARD_CODE

    return "".join(
        STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
        for b in map(int, np.argmax(prof.match_codonp, axis=1))
    )


def cli(*args) -> None:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deciphon_tpu_torch.cli.main", *args],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise SystemExit(
            f"cli {args[0]} failed ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    print(f"cli {args[0]}: {time.perf_counter() - t0:.1f} s: "
          f"{proc.stdout.strip().splitlines()[-1]}")


def timed_ms(fn, reps: int = 1) -> float:
    """Min over ``reps`` of CUDA-event milliseconds around fn()."""
    import torch

    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def phase_main_path(dev, workdir: str) -> dict:
    import torch

    from deciphon_tpu.db.format import TensorDB
    from deciphon_tpu.models.h3writer import random_h3, write_h3
    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops.scan_engine import (
        ScanEngine, ScanParams, SeqRecord,
    )

    rng = np.random.default_rng(42)
    sizes = ragged_core_sizes(rng)
    hmm = os.path.join(workdir, "pfam_shaped.hmm")
    dtp = os.path.join(workdir, "pfam_shaped.dtp")
    t0 = time.perf_counter()
    with open(hmm, "w") as fp:
        write_h3(fp, [
            random_h3(s + 1, int(k), peak=0.8) for s, k in enumerate(sizes)
        ])
    print(f"db: {NPROF} profiles, {int(sizes.sum())} nodes "
          f"(.hmm written in {time.perf_counter() - t0:.1f} s)")
    cli("press", hmm, "-o", dtp)
    db = TensorDB.load(dtp)
    assert db.nprofiles == NPROF

    # 256 reads of 150-500 nt; 8 are consensus reads of known profiles
    lens = rng.integers(150, 500, NREADS)
    reads = ["".join(rng.choice(list("ACGT"), int(n))) for n in lens]
    fit = np.flatnonzero((db.core_sizes >= 50) & (db.core_sizes <= 166))
    targets = [int(t) for t in rng.choice(fit, NPLANTED, replace=False)]
    slots = rng.choice(NREADS, NPLANTED, replace=False)
    for t, slot in zip(targets, slots):
        reads[slot] = consensus_dna(db.profile(t))
    planted = {int(slot) + 1: t for t, slot in zip(targets, slots)}
    fasta = os.path.join(workdir, "reads.fa")
    with open(fasta, "w") as fp:
        fp.writelines(f">r{i + 1}\n{r}\n" for i, r in enumerate(reads))
    tsv = os.path.join(workdir, "prods.tsv")
    cli("scan", dtp, fasta, "-o", tsv, "--device", dev.type)
    rows = [ln.split("\t") for ln in open(tsv).read().splitlines()[1:]]
    got = {(int(r[1]), r[2]) for r in rows}
    for sid, t in planted.items():
        if (sid, db.profile(t).accession) not in got:
            raise SystemExit(f"cli scan: planted read {sid} missed "
                             f"profile {t}")
    print(f"cli scan: {len(rows)} rows, all {NPLANTED} planted reads hit")

    # the same path in process: launches, pass-1 cells, timings
    seqs = [SeqRecord(i + 1, f"r{i + 1}", r) for i, r in enumerate(reads)]
    engine = ScanEngine(db, ScanParams(), device=dev)
    t0 = time.perf_counter()
    engine.prepare()
    torch.cuda.synchronize()
    print(f"engine: {len(engine.blocks)} blocks, tables built in "
          f"{time.perf_counter() - t0:.2f} s")
    vc.LAUNCHES = 0
    hits = engine.scan(seqs)
    launches = vc.LAUNCHES
    if launches != len(engine.blocks):
        raise SystemExit(f"main path launched the kernel {launches} times "
                         f"for {len(engine.blocks)} blocks")
    hit_set = {(h.seq_id, h.profile_idx) for h in hits}
    missed = [s for s, t in planted.items() if (s, t) not in hit_set]
    if missed:
        raise SystemExit(f"engine scan: planted reads {missed} missed")
    for h in hits:
        if not (np.isfinite(h.alt_loglik) and h.match):
            raise SystemExit(f"engine scan: malformed hit {h}")
    alt, null = engine.last_scores
    if alt.shape != (NREADS, NPROF) or not np.isfinite(alt).all():
        raise SystemExit("engine scan: pass-1 scores not finite [256, 1024]")
    print(f"engine scan: {len(hits)} hits, kernel launches {launches}")

    # every pass-1 cell of that run against the plain version
    order, eidx, slen = engine.batch(engine.encode(seqs))
    plains = []

    def run_plain():
        plains.clear()
        for blk in engine.blocks:
            plains.append(vc.scores_plain(engine.packed(blk), eidx, slen))

    plain_ms = timed_ms(run_plain)
    worst = 0.0
    for blk, (pa, pn) in zip(engine.blocks, plains):
        for got_, want in ((alt, pa), (null, pn)):
            run = torch.from_numpy(got_[np.ix_(order, blk.chunk)]).to(dev)
            d, excess = max_excess(run, want)
            if excess > 0:
                raise SystemExit(f"pass-1 cell off plain at kpad {blk.kpad}:"
                                 f" max|d| {d}")
            worst = max(worst, d)
    print(f"pass 1: all {alt.size} cells x (alt, null) equal plain within "
          f"tolerance, max|d| {worst:.3g}")

    def run_kernel():
        for blk in engine.blocks:
            vc.scores(engine.packed(blk), eidx, slen)

    kernel_ms = timed_ms(run_kernel, reps=3)
    print(f"pass-1 kernel {kernel_ms:.3f} ms vs plain {plain_ms:.3f} ms "
          f"over {len(engine.blocks)} blocks")

    scan_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        ms = timed_ms(lambda: engine.scan(seqs))
        scan_s.append((ms / 1e3, time.perf_counter() - t0))
    warm = min(s for s, _ in scan_s)
    tm = engine.last_timings
    kpad_of = {int(g): b.kpad for b in engine.blocks for g in b.chunk}
    print(f"warm scan phases (host clock, last run): pass 1 "
          f"{tm['pass1']:.4f} s, gate {tm['gate']:.4f} s, pass 2 "
          f"{tm['pass2']:.4f} s for {tm['survivors']} survivors in "
          f"{len({kpad_of[h.profile_idx] for h in hits})} width groups")
    cells = 3 * sum(map(len, reads)) * int(db.core_sizes.sum())
    print(f"warm scan (min of 3, CUDA events): {warm:.4f} s "
          f"(host clock {min(h for _, h in scan_s):.4f} s), "
          f"{cells / warm / 1e9:.2f} GCUPS (3 x sum len x sum core)")
    return dict(launches=launches, max_abs_err=worst, ms=kernel_ms,
                plain_ms=plain_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from deciphon_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS:.2f} s)")
    for line in _build.BUILD_LOG.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill",
                                   "error")):
            print(f"  ptxas: {line.strip()}")
    menu_err = phase_kernel_menu(dev)
    # scratch for the synthetic DB and reads, inside the checkout
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        main_path = phase_main_path(dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    main_path["max_abs_err"] = max(main_path["max_abs_err"], menu_err)
    if "jax" in sys.modules:
        raise SystemExit("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "viterbi_max", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, **main_path,
    }]}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
