#!/usr/bin/env python3
"""On-card smoke test of the deciphon_tpu_torch scan path (one NVIDIA GPU).

    python3 chip_smoke.py              # needs one CUDA card; ~7 min on an H100
    python3 chip_smoke.py --menu-only  # phases 1-2, then stop

Phases, each fatal on failure:
  1. the card (nvidia-smi name, power limit and maximum SM clock) and
     the kernel build (nvcc, sm_90a, one process per source) from csrc/
     in this checkout, with each kernel's registers and spills;
  2. both kernels (Viterbi = max, csrc/viterbi.cu; forward = logsumexp,
     csrc/forward.cu, in scaled probability space) against their plain
     torch version on the card, over a menu of core sizes, read lengths
     and flags on base-4 tables, and on base-5 ("N") and base-6 ("N",
     "R") tables with N at read positions 1-5 and R mid-read; every
     block holds a profile with two dead DD links, and every launch plan
     of the Viterbi kernel (viterbi_cuda.viterbi_plan) runs; then reads
     of two copies of a strong domain (K 40, 129 and 512, each copy > 100
     nats over the null) on the forward kernel under all four flag
     pairs, held against the f32 plain version up to 1000 nt and the
     f64 one above.  Tolerance: 1e-4 + 1e-6 * |plain| (max), 1e-3 +
     1e-5 * |plain| (logsumexp);
  3. the main path at a Pfam-shaped size: press a synthetic 1024-profile
     .hmm, then scan one mixed read set (256 ACGT reads, 24 reads with N,
     8 with N and R) under Viterbi and under --forward, each with the
     port's CLI (subprocess) and the same engine in process: planted
     reads (also those holding N, and N and R) must hit their profiles,
     the semiring's kernel must have been launched once per block and
     read class, every pass-1 cell of every class must equal the plain
     version, and no jax may be loaded.  Kernel-vs-plain times per class,
     warm scan seconds and GCUPS are timed with CUDA events, and each
     kernel's bound is computed from the same inputs: the larger of its
     bytes over 3.35 TB/s and its operations over the card's rates (see
     `bound`); the ACGT class under Viterbi also prints one line per
     block (width, profiles, launch plan, ms, share of its bound);
  4. the profile-sharded engine on the same DB and reads: a mesh over
     every visible card, or on one card ["cuda:0"] * 4 as 2 read shards x
     2 profile shards.  Viterbi and forward scans and best hits: every
     pass-1 cell of every class must equal the unsharded engine's bit for
     bit, the hits and best-hit winners must be identical, and the
     kernel must have been launched tiles x blocks x classes times;
  5. the scheduler daemon, Server(device="cuda"), against the port's
     FakeScheduler on localhost: a press job of the same .hmm (the
     uploaded .dtp must equal the CLI's byte for byte), a scan job of the
     288 reads and a DCP_BEST_HIT=1 scan job, whose products must equal
     phase 3's in-process hits (logliks within 1e-4 + 1e-6 * |x|) and
     best hits; every planted read must hit, and the kernel must have
     been launched.  A failed job is fatal.
The last two lines are the card line and a JSON {"ok": true, ...}; the
line before them is the JSON kernel table, which lists per kernel the
launches of each path (scan, sharded, daemon) beside phase 3's.
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

# (absolute, relative) tolerance of kernel vs plain, per semiring.  Max:
# both sides add the same f32 values, only the order of the maxima
# differs.  Logsumexp: the kernel sums linear f32 values scaled by powers
# of two where the plain version joins logs with torch.logsumexp /
# logcumsumexp, so each step may round differently, over up to 600
# positions.
TOL = {"max": (1e-4, 1e-6), "logsumexp": (1e-3, 1e-5)}
KERNEL_SOURCE = {"max": "deciphon_tpu_torch/csrc/viterbi.cu",
                 "logsumexp": "deciphon_tpu_torch/csrc/forward.cu"}
KERNEL_REPLACES = "deciphon_tpu/ops/viterbi_pallas.py:178"
KERNEL_NAME = {"max": "viterbi_max", "logsumexp": "viterbi_lse"}
ALGO = {"max": "viterbi", "logsumexp": "forward"}
MENU_K = (8, 129, 768, 896, 1536, 2048, 4096)
# Viterbi only: the rest of the kernel's launch plans
# (viterbi_cuda.viterbi_plan), each boundary with the width after it:
# one warp of 2, 3, 4, 6, 7, 8 nodes a lane with rings in registers (K
# 40 -> 64, 96, 128, 192, 193 -> 224, 256; 8 and 129 give 1 and 5), of
# 9..12 with rings in shared memory (257 -> 288, 320, 352, 384), the
# first CTA plan (385 -> 416), the last plan of 4 nodes a lane (1024)
# and the first of 8 (1025 -> 1056), the first 16-warp plan
# (2049 -> 2080); two flag pairs each (the flags change only the
# specials, which every plan computes alike)
VIT_MENU_K = (40, 96, 128, 192, 193, 256, 257, 320, 352, 384, 385, 1024,
              1025, 2049)
MENU_LENS = (0, 1, 2, 4, 5, 27, 254, 255, 256, 600)  # 0: a padding row
FLAGS = ((True, False), (False, False), (True, True), (False, True))
# extended tables: base 5 and base 6 over a shorter K menu, two flag pairs
EXT_CODES = (("N",), ("N", "R"))
EXT_K = (8, 129, 896, 2048, 4096)
EXT_FLAGS = ((True, False), (False, True))
# two copies of a peaked profile's consensus in one read, forward only,
# all four flag pairs
TWO_COPY_K = (40, 129, 512)  # NPT 4 and 8; reads up to 814 nt, and 3112
# Reads longer than this hold forward against the plain version in f64:
# the f32 plain version's own rounding grows with read length (logaddexp
# rounds to f32's step at |score| ~ 1e3 and the steps accumulate), so on
# 3112-nt reads it is no yardstick at the kernel's tolerance.
F64_YARDSTICK_NT = 1000
NPROF = 1024
NREADS = 256  # ACGT reads
NPLANTED = 8  # of them consensus reads of known profiles
N_READS, N_PLANTED = 24, 8  # reads with N; consensus reads with one N
NR_READS, NR_PLANTED = 8, 2  # reads with N and R; planted ones
# the card's published peaks (H100 SXM data sheet, 700 W): HBM bytes/s
# and f32 operations/s outside the tensor cores (an FMA counted as two)
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# issue rates per SM and clock (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0): 128 f32 lanes, 16
# special-function (MUFU) lanes; the H100 SXM has 132 SMs
SMS, F32_LANES, MUFU_LANES = 132, 128, 16
# Viterbi: f32 operations of the recurrence per (core node, position), as
# viterbi_pallas._kernel (semiring "max", position() :626-713) and
# viterbi_cuda.scores_plain write it, whatever kernel runs it; a join is
# one max, a shift moves data and costs nothing:
#   match in-flow   ring_cs[slot] + em_m, 5 lookbacks: 5 adds, 4 joins   9
#   insert in-flow  ring_ic[slot] + em_i, the same:    5 adds, 4 joins   9
#   D-chain         accM + a_base (add), the prefix scan's join at this
#                   node, cdd + shifted prefix (add), the NEG clamp     4
#   VE              join(accM, VD), the reduce's join at this node       2
#   core out-flow   accM + mm_out, accI + im_out, VD + dm_out: 3 adds,
#                   2 joins                                             5
#   ring_cs write   VB + entry (add), join with the shifted core        2
#   ring_ic write   accM + mi, accI + ii (adds), 1 join                 3
# = 18 adds + 15 joins + 1 clamp.  No FMA: each is one f32 instruction at
# the issue rate SMS * F32_LANES * clock.  The specials (N, J, C, R, VB,
# VT) are per (read, profile, position), not per node, and are left out
# as in the forward count.
MAX_OPS = 18 + 15 + 1
# Forward: the recurrence's work per (node, position) in probability
# space, whatever kernel runs it: 15 FMAs (5 match and 5 insert in-flow
# accumulations, 1 D-chain step, 2 in the core out-flow, 1 in each ring
# write), 18 other f32 instructions (5 ring x emission products, 5
# log2(e) scalings of the gathered log entries, M x MD, D x DM, I x II,
# 2 adds for VE, 3 maxima for the values' scales) and 5 exponentials of
# the gathered match entries on the MUFU pipe
FWD_FMA, FWD_OTHER, FWD_MUFU = 15, 18, 5
# the paths of phases 3-5, in the kernel table's "paths"
PATHS = ("scan", "sharded", "daemon")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def max_excess(got, want, semiring: str) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| - tolerance)."""
    tol_abs, tol_rel = TOL[semiring]
    d = (got - want).abs()
    return float(d.max()), float((d - (tol_abs + tol_rel * want.abs())).max())


def encode(read: str, codes: tuple) -> np.ndarray:
    """ACGT -> 0..3, codes[j] -> 4+j (alphabet.encode_extended's symbols
    for a read class of ``codes``)."""
    return np.array(
        ["ACGT".index(c) if c in "ACGT" else 4 + codes.index(c) for c in read],
        np.int8,
    )


def eidx_of(reads, pad_to: int, codes: tuple = ()):
    from deciphon_tpu_torch.ops.emissions import fragment_indices
    from deciphon_tpu_torch.ops.viterbi_torch import end_fragment_indices

    base = 4 + len(codes)
    return np.stack([
        end_fragment_indices(
            fragment_indices(encode(r, codes), pad_to=pad_to, base=base),
            base,
        )
        for r in reads
    ])


def menu_reads(codes: tuple) -> list[str]:
    """MENU_LENS random reads; with codes, codes[0] at one of positions
    1-5 of every read and codes[-1] in the middle of reads of >= 3 nt."""
    rng = np.random.default_rng(7)
    reads = [list(rng.choice(list("ACGT"), n)) for n in MENU_LENS]
    if codes:
        for j, r in enumerate(reads):
            if r:
                r[j % min(5, len(r))] = codes[0]
            if len(r) >= 3:
                r[len(r) // 2] = codes[-1]
    return ["".join(r) for r in reads]


def phase_kernel_menu(dev) -> dict:
    """Worst |kernel - plain| per semiring over the menu."""
    import torch

    from deciphon_tpu_torch.models.h3reader import build_profile
    from deciphon_tpu_torch.models.h3writer import random_h3
    from deciphon_tpu_torch.models.profile import sample_profile
    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops.viterbi_torch import NEG

    worst = dict.fromkeys(TOL, 0.0)
    ncells = 0
    menu = ([((), K, FLAGS, tuple(TOL)) for K in MENU_K]
            + [((), K, EXT_FLAGS, ("max",)) for K in VIT_MENU_K]
            + [(c, K, EXT_FLAGS, tuple(TOL)) for c in EXT_CODES
               for K in EXT_K])
    plans = set()
    for codes in dict.fromkeys(m[0] for m in menu):
        reads = menu_reads(codes)
        eidx = torch.from_numpy(eidx_of(reads, max(MENU_LENS), codes)).to(dev)
        slen = torch.tensor(MENU_LENS, dtype=torch.int32, device=dev)
        for K, flags, semirings in ((m[1], m[2], m[3]) for m in menu
                                    if m[0] == codes):
            # ragged block: cores below the padded width leave padding
            # nodes; the last profile repeats the widest with two dead DD
            # links inside its core (the -1e4 clamp of the D-chain)
            cores = sorted({K, max(2, K - 5), max(2, K // 2), max(2, K // 3)})
            profiles = [
                sample_profile(100 * K + j, k) for j, k in enumerate(cores)
            ]
            dd = profiles[-1].dd_in.copy()
            dd[[K // 3, 2 * K // 3]] = -np.inf
            profiles.append(replace(profiles[-1], dd_in=dd))
            blk = vc.CudaBlock.from_profiles(profiles, device=dev,
                                             codes=codes)
            plans.add(vc.viterbi_plan(blk.kpad)[:3])
            for semiring in semirings:
                for mh, h3 in flags:
                    alt, null = vc.scores(blk, eidx, slen, mh, h3, semiring)
                    palt, pnull = vc.scores_plain(blk, eidx, slen, mh, h3,
                                                  semiring)
                    torch.cuda.synchronize()
                    da, ea = max_excess(alt, palt, semiring)
                    dn, en = max_excess(null, pnull, semiring)
                    finite = bool(torch.isfinite(alt[1:]).all() and
                                  torch.isfinite(null[1:]).all())
                    pad_row = bool((alt[0] == NEG).all() and
                                   (null[0] == NEG).all())
                    shape = (f" plan {plan_str(vc.viterbi_plan(blk.kpad))}"
                             if semiring == "max" else "")
                    print(f"menu {codes or 'ACGT'} ntab={blk.fm.shape[1]} "
                          f"K={K} kpad={blk.kpad}{shape} {semiring} "
                          f"multi_hits={mh} hmmer3_compat={h3}: "
                          f"max|d| alt {da:.3g} null {dn:.3g}")
                    if not (finite and pad_row) or max(ea, en) > 0:
                        per = (alt - palt).abs().amax(1).tolist()
                        print("  per read length: " + " ".join(
                            f"{n}:{d:.2g}" for n, d in zip(MENU_LENS, per)))
                        raise SystemExit(f"{semiring} kernel disagrees with "
                                         f"plain at K={K}, codes={codes}")
                    worst[semiring] = max(worst[semiring], da, dn)
                    ncells += 1
            del blk
    # every launch plan of the Viterbi kernel ran
    every = {p[:3] for p in map(vc.viterbi_plan, range(32, 4097, 32))}
    if plans != every:
        raise SystemExit(f"menu missed Viterbi plans {every - plans}")
    # reads of two copies of a strong domain: the first copy's paths
    # end > 100 nats above a fresh start from N at the second (beyond
    # f32's range), and under multi_hits = false only N starts a hit.
    # Up to F64_YARDSTICK_NT the kernel is held against the f32 plain
    # version, above it against the f64 one; both distances are printed.
    rng = np.random.default_rng(11)
    semiring = "logsumexp"  # the Viterbi kernel has no scales
    for K in TWO_COPY_K:
        prof = build_profile(random_h3(K, K, peak=0.9))
        reads = two_copy_reads(consensus_dna(prof), rng)
        lens = [len(r) for r in reads]
        eidx = torch.from_numpy(eidx_of(reads, max(lens))).to(dev)
        slen = torch.tensor(lens, dtype=torch.int32, device=dev)
        blk = vc.CudaBlock.from_profiles(
            [prof, sample_profile(K, max(2, K // 2))], device=dev)
        f64 = max(lens) > F64_YARDSTICK_NT
        for mh, h3 in FLAGS:
            got = vc.scores(blk, eidx, slen, mh, h3, semiring)
            plain = vc.scores_plain(blk, eidx, slen, mh, h3, semiring)
            exact = vc.scores_plain(blk, eidx, slen, mh, h3, semiring,
                                    dtype=torch.float64)
            torch.cuda.synchronize()
            ref = exact if f64 else plain
            (da, ea), (dn, en) = (max_excess(g.double(), r.double(),
                                             semiring)
                                  for g, r in zip(got, ref))
            k64 = [float((g.double() - e).abs().max())
                   for g, e in zip(got, exact)]
            p64 = [float((p.double() - e).abs().max())
                   for p, e in zip(plain, exact)]
            lrt = float(plain[0][0, 0] - plain[1][0, 0])
            print(f"two copies K={K} ({max(lens)} nt) {semiring} "
                  f"multi_hits={mh} hmmer3_compat={h3}: max|d| vs "
                  f"{'f64' if f64 else 'f32'} plain alt {da:.3g} null "
                  f"{dn:.3g}; kernel vs f64 plain alt {k64[0]:.3g} null "
                  f"{k64[1]:.3g}; f32 plain vs f64 plain alt {p64[0]:.3g} "
                  f"null {p64[1]:.3g} (equal copies: alt - null {lrt:.0f} "
                  "nats)")
            finite = bool(torch.isfinite(got[0]).all() and
                          torch.isfinite(got[1]).all())
            if not finite or max(ea, en) > 0:
                per = (got[0].double() - ref[0].double()).abs()[:, 0]
                print("  per read: " + " ".join(
                    f"{d:.2g}" for d in per.tolist()))
                raise SystemExit(f"{semiring} kernel disagrees with "
                                 f"plain on two copies, K={K}")
            worst[semiring] = max(worst[semiring], da, dn)
            ncells += 1
        del blk
    print(f"menu: all {ncells} cells within tolerance, max|d| "
          + ", ".join(f"{s} {w:.3g}" for s, w in worst.items())
          + f"; Viterbi plans run: {len(plans)}")
    return worst


def plan_str(p) -> str:
    """A Viterbi launch plan in a few characters: nodes a lane, warps per
    read x reads per CTA, ring storage."""
    return (f"npt{p.npt}/w{p.warps}x{p.reads}/"
            f"{'reg' if p.reg_ring else 'smem'}")


def two_copy_reads(cons: str, rng) -> list[str]:
    """Two copies of ``cons``: equal, the first weaker (a ninth of its
    codons redrawn), the first stronger, and 40 nt apart."""
    weak = list(cons)
    for j in rng.choice(len(cons) // 3, len(cons) // 9, replace=False):
        weak[3 * j: 3 * j + 3] = rng.choice(list("ACGT"), 3)
    weak = "".join(weak)
    return [cons + cons, weak + cons, cons + weak,
            cons + "ACGTTGCA" * 5 + cons]


def ragged_core_sizes(rng) -> np.ndarray:
    """bench.py's Pfam-like draw (bench.py:201-209): lognormal, median
    150, sigma 0.8, clipped to 16..4096, plus 1024/2048/4096 outliers."""
    tail = [1024, 2048, 4096]
    sizes = np.exp(rng.normal(np.log(150.0), 0.8, NPROF - len(tail)))
    sizes = np.clip(sizes, 16, 4096).astype(np.int64)
    return np.concatenate([sizes, tail]).astype(np.int64)


def consensus_dna(prof) -> str:
    from deciphon_tpu_torch.models.alphabet import STANDARD_CODE

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


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0]
    return float(mhz) * 1e6


def ops_seconds(semiring: str, clock: float) -> float:
    """Least seconds per core (node, position) on the card's arithmetic:
    for Viterbi its f32 instructions at the issue rate; for forward the
    larger of its f32 time (FMAs at PEAK_F32 as two operations each,
    other f32 instructions at the issue rate) and its MUFU time."""
    if semiring == "max":
        return MAX_OPS / (SMS * F32_LANES * clock)
    f32 = 2 * FWD_FMA / PEAK_F32 + FWD_OTHER / (SMS * F32_LANES * clock)
    return max(f32, FWD_MUFU / (SMS * MUFU_LANES * clock))


def bound(nbytes: int, node_pos: int, semiring: str, clock: float):
    """(bound ms, "bytes" or "operations") of launches that move
    ``nbytes`` and compute ``node_pos`` (node, position) cells."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = node_pos * ops_seconds(semiring, clock)
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def launch_work(blk, eidx, slen, semiring: str,
                nodes: int) -> tuple[int, int]:
    """(bytes, (node, position) cells) of one launch: each table, plane,
    read and output byte once; at every read position, the ``nodes``
    core nodes of the block's profiles (the recurrence's own work,
    whatever padding, lane fill or loads a kernel picks)."""
    B = blk.fm.shape[0]
    S = eidx.shape[0]
    planes = blk.trans if semiring == "max" else blk.ptrans
    nbytes = 4 * (blk.fm.numel() + blk.fin.numel() + planes.numel()
                  + eidx.numel() + slen.numel() + 3 * S + 2 * S * B)
    return nbytes, int(slen.sum()) * nodes


def reset_launches() -> None:
    from deciphon_tpu_torch.ops import viterbi_cuda as vc

    for k in vc.LAUNCHES:
        vc.LAUNCHES[k] = 0


def mixed_reads(rng, db):
    """(reads, planted {seq_id: profile}): the 256 ACGT reads of 150-500
    nt with 8 consensus reads planted, then 24 reads with N (8 of them
    consensus reads of other profiles with one N inside) and 8 with N and
    R (2 of them consensus reads with one N and one R on an A or G)."""
    lens = rng.integers(150, 500, NREADS)
    reads = ["".join(rng.choice(list("ACGT"), int(n))) for n in lens]
    fit = np.flatnonzero((db.core_sizes >= 50) & (db.core_sizes <= 166))
    targets = [int(t) for t in rng.choice(fit, NPLANTED, replace=False)]
    slots = rng.choice(NREADS, NPLANTED, replace=False)
    for t, slot in zip(targets, slots):
        reads[slot] = consensus_dna(db.profile(t))
    planted = {int(slot) + 1: t for t, slot in zip(targets, slots)}

    others = rng.choice(np.setdiff1d(fit, targets), N_PLANTED + NR_PLANTED,
                        replace=False)
    for j in range(N_READS + NR_READS):
        nr = j >= N_READS
        if j < N_PLANTED or N_READS <= j < N_READS + NR_PLANTED:
            t = int(others[j if j < N_PLANTED else N_PLANTED + j - N_READS])
            r = list(consensus_dna(db.profile(t)))
            planted[len(reads) + 1] = t
            marks = 1
        else:
            r = list(rng.choice(list("ACGT"), int(rng.integers(150, 500))))
            marks = int(rng.integers(1, 4))
        for p in rng.choice(np.arange(3, len(r) - 3), marks, replace=False):
            r[p] = "N"
        if nr:
            ag = [p for p in range(len(r) // 3, len(r)) if r[p] in "AG"]
            r[ag[len(ag) // 2]] = "R"
        reads.append("".join(r))
    return reads, planted


def check_planted(hit_pairs: set, planted: dict, what: str) -> None:
    missed = [(s, t) for s, t in planted.items() if (s, t) not in hit_pairs]
    if missed:
        raise SystemExit(f"{what}: planted (read, profile) {missed} missed")
    print(f"{what}: all {len(planted)} planted reads hit")


def phase_main_path(dev, workdir: str, clock: float):
    """(per semiring: launches, max_abs_err, ms, plain_ms, bound_ms,
    bound_by of the main path; the context phases 4 and 5 compare
    with)."""
    import torch

    from deciphon_tpu_torch.db.format import TensorDB
    from deciphon_tpu_torch.models.h3writer import random_h3, write_h3
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

    reads, planted = mixed_reads(rng, db)
    fasta = os.path.join(workdir, "reads.fa")
    with open(fasta, "w") as fp:
        fp.writelines(f">r{i + 1}\n{r}\n" for i, r in enumerate(reads))
    seqs = [SeqRecord(i + 1, f"r{i + 1}", r) for i, r in enumerate(reads)]
    nodes = int(db.core_sizes.sum())
    cells = 3 * sum(map(len, reads)) * nodes
    out = {}
    ctx = dict(db=db, seqs=seqs, planted=planted, hmm=hmm, dtp=dtp,
               cells=cells, scores={}, warm={})
    for semiring in TOL:
        algo = ALGO[semiring]
        print(f"--- main path, {algo} ({semiring}) ---")
        tsv = os.path.join(workdir, f"prods_{algo}.tsv")
        cli("scan", dtp, fasta, "-o", tsv, "--device", dev.type,
            *(["--forward"] if algo == "forward" else []))
        rows = [ln.split("\t") for ln in open(tsv).read().splitlines()[1:]]
        acc_of = {db.profile(t).accession: t for t in planted.values()}
        check_planted({(int(r[1]), acc_of.get(r[2])) for r in rows}, planted,
                      f"cli scan ({len(rows)} rows)")

        # the same path in process: launches, pass-1 cells, timings
        engine = ScanEngine(db, ScanParams(algo=algo), device=dev)
        t0 = time.perf_counter()
        engine.prepare()
        torch.cuda.synchronize()
        print(f"engine: {len(engine.blocks)} blocks, base-4 tables built in "
              f"{time.perf_counter() - t0:.2f} s")
        encoded, classes = engine.encode(seqs)
        reset_launches()
        hits = engine.scan(seqs)
        launches = dict(vc.LAUNCHES)
        want = len(engine.blocks) * len(classes)
        other = sum(n for s, n in launches.items() if s != semiring)
        if launches[semiring] != want or other:
            raise SystemExit(f"main path launches {launches}: want "
                             f"{want} {semiring} (blocks x classes)")
        check_planted({(h.seq_id, h.profile_idx) for h in hits}, planted,
                      f"engine scan ({len(hits)} hits)")
        for h in hits:
            if not (np.isfinite(h.alt_loglik) and h.match):
                raise SystemExit(f"engine scan: malformed hit {h}")
        alt, null = engine.last_scores
        if alt.shape != (len(reads), NPROF) or not np.isfinite(alt).all():
            raise SystemExit("engine scan: pass-1 scores not finite "
                             f"[{len(reads)}, {NPROF}]")
        print(f"engine scan: {launches[semiring]} {KERNEL_NAME[semiring]} "
              f"launches = {len(engine.blocks)} blocks x {len(classes)} "
              "classes")
        ctx["scores"][semiring] = engine.last_scores
        ctx["classes"] = len(classes)
        if semiring == "max":
            ctx["hits"] = hits
            ctx["best"] = engine.best_hits(seqs)

        # every pass-1 cell of that run against the plain version, and
        # kernel vs plain times, class by class
        worst = kernel_ms = plain_ms = 0.0
        nbytes = node_pos = 0
        for codes in sorted(classes):
            ids = classes[codes]
            order, eidx, slen = engine.batch([encoded[si] for si in ids],
                                             codes)
            rows_ = [ids[j] for j in order]
            t0 = time.perf_counter()
            blks = [engine.packed(b, codes) for b in engine.blocks]
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            plains = []

            def run_plain():
                plains.clear()
                for blk in blks:
                    plains.append(vc.scores_plain(
                        blk, eidx, slen, semiring=semiring))

            def run_kernel():
                for blk in blks:
                    vc.scores(blk, eidx, slen, semiring=semiring)

            p_ms = timed_ms(run_plain)
            k_ms = timed_ms(run_kernel, reps=3)
            if semiring == "max" and not codes:
                block_lines(engine, blks, eidx, slen, db, clock)
            c_bytes = c_cells = 0
            for b, blk in zip(engine.blocks, blks):
                b_, c_ = launch_work(blk, eidx, slen, semiring,
                                     int(db.core_sizes[b.chunk].sum()))
                c_bytes += b_
                c_cells += c_
            c_bound, c_by = bound(c_bytes, c_cells, semiring, clock)
            nbytes += c_bytes
            node_pos += c_cells
            d_cls = 0.0
            for b, (pa, pn) in zip(engine.blocks, plains):
                for got_, want_ in ((alt, pa), (null, pn)):
                    run = torch.from_numpy(
                        got_[np.ix_(rows_, b.chunk)]).to(dev)
                    d, excess = max_excess(run, want_, semiring)
                    if excess > 0:
                        raise SystemExit(
                            f"pass-1 cell off plain: {semiring}, class "
                            f"{codes}, kpad {b.kpad}: max|d| {d}")
                    d_cls = max(d_cls, d)
            print(f"class {codes or 'ACGT'} ({len(ids)} reads, ntab "
                  f"{blks[0].fm.shape[1]}): {len(ids) * NPROF} cells x "
                  f"(alt, null) equal plain, max|d| {d_cls:.3g}; kernel "
                  f"{k_ms:.3f} ms vs plain {p_ms:.3f} ms over "
                  f"{len(blks)} blocks; tables {build_s:.3f} s (host clock); "
                  f"bound {c_bound:.3f} ms by {c_by} ({c_bytes} B, "
                  f"{c_cells} node-positions), kernel at "
                  f"{100 * c_bound / k_ms:.1f}% of it")
            worst = max(worst, d_cls)
            kernel_ms += k_ms
            plain_ms += p_ms
            del blks, plains
        torch.cuda.empty_cache()

        scan_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            ms = timed_ms(lambda: engine.scan(seqs))
            scan_s.append((ms / 1e3, time.perf_counter() - t0))
        warm = min(s for s, _ in scan_s)
        ctx["warm"][semiring] = warm
        tm = engine.last_timings
        print(f"warm scan phases (host clock, last run): pass 1 "
              f"{tm['pass1']:.4f} s (incl. extended tables), gate "
              f"{tm['gate']:.4f} s, pass 2 {tm['pass2']:.4f} s for "
              f"{tm['survivors']} survivors")
        print(f"warm scan {algo} (min of 3, CUDA events): {warm:.4f} s "
              f"(host clock {min(h for _, h in scan_s):.4f} s), "
              f"{cells / warm / 1e9:.2f} GCUPS (3 x sum len x sum core, "
              f"{len(reads)} reads)")
        bound_ms, bound_by = bound(nbytes, node_pos, semiring, clock)
        print(f"bound {KERNEL_NAME[semiring]}: {bound_ms:.3f} ms by "
              f"{bound_by} ({1e12 * ops_seconds(semiring, clock):.4f} ps of "
              f"arithmetic per node-position, {node_pos} node-positions); "
              f"kernel {kernel_ms:.3f} ms, "
              f"{100 * bound_ms / kernel_ms:.1f}% of the bound")
        out[semiring] = dict(launches=launches[semiring], max_abs_err=worst,
                             ms=kernel_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None)
        del engine
        torch.cuda.empty_cache()
    return out, ctx


def block_lines(engine, blks, eidx, slen, db, clock) -> None:
    """One line per block of a class under Viterbi: padded width,
    profiles, launch plan, kernel ms (min of 3, CUDA events) and the
    share of that block's bound."""
    from deciphon_tpu_torch.ops import viterbi_cuda as vc

    for b, blk in zip(engine.blocks, blks):
        ms = timed_ms(lambda blk=blk: vc.scores(blk, eidx, slen), reps=3)
        nbytes, cells = launch_work(blk, eidx, slen, "max",
                                    int(db.core_sizes[b.chunk].sum()))
        b_ms, b_by = bound(nbytes, cells, "max", clock)
        print(f"  block K={blk.kpad} B={blk.fm.shape[0]} plan "
              f"{plan_str(vc.viterbi_plan(blk.kpad))}: {ms:.3f} ms, bound "
              f"{b_ms:.3f} ms by {b_by}, {100 * b_ms / ms:.1f}% of it")


def scan_mesh():
    """(mesh, kind): every visible card, or on one card 2 read shards x
    2 profile shards of cuda:0."""
    import torch

    from deciphon_tpu_torch.parallel.mesh import make_scan_mesh

    n = torch.cuda.device_count()
    if n > 1:
        mesh = make_scan_mesh()
        return mesh, f"{n} cards"
    mesh = make_scan_mesh(profile_axis=2, seq_axis=2,
                          devices=["cuda:0"] * 4)
    return mesh, "one card, cuda:0 repeated"


def phase_sharded(ctx) -> dict:
    """Per semiring: launches of the sharded scans."""
    import torch

    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine, ScanParams

    db, seqs = ctx["db"], ctx["seqs"]
    mesh, kind = scan_mesh()
    print(f"mesh: {mesh.seqs} read shards x {mesh.profiles} profile shards "
          f"({kind})")
    out = {}
    for semiring in TOL:
        algo = ALGO[semiring]
        engine = ScanEngine(db, ScanParams(algo=algo), mesh=mesh)
        t0 = time.perf_counter()
        engine.prepare()
        torch.cuda.synchronize()
        ntiles = sum(len(b.tiles) for b in engine.blocks)
        print(f"sharded {algo}: {len(engine.blocks)} blocks, {ntiles} tiles, "
              f"base-4 tables built in {time.perf_counter() - t0:.2f} s")
        reset_launches()
        hits = engine.scan(seqs)
        launches = dict(vc.LAUNCHES)
        want = ntiles * ctx["classes"]
        other = sum(n for s, n in launches.items() if s != semiring)
        if launches[semiring] != want or other:
            raise SystemExit(f"sharded launches {launches}: want {want} "
                             f"{semiring} (tiles x classes)")
        print(f"sharded scan: {want} {KERNEL_NAME[semiring]} launches = "
              f"{ntiles} tiles over {len(engine.blocks)} blocks x "
              f"{ctx['classes']} classes")
        for name, got, ref in zip(("alt", "null"), engine.last_scores,
                                  ctx["scores"][semiring]):
            if not np.array_equal(got, ref):
                d = float(np.abs(got - ref).max())
                raise SystemExit(f"sharded {algo} {name} differs from "
                                 f"unsharded: max|d| {d}")
        print(f"sharded {algo}: all {got.size} pass-1 cells x (alt, null) "
              "equal the unsharded engine's bit for bit")
        check_planted({(h.seq_id, h.profile_idx) for h in hits},
                      ctx["planted"], f"sharded {algo} ({len(hits)} hits)")
        if semiring == "max":
            if [(h.seq_id, h.profile_idx, h.match) for h in hits] != [
                (h.seq_id, h.profile_idx, h.match) for h in ctx["hits"]
            ]:
                raise SystemExit("sharded hits differ from unsharded")
            best = engine.best_hits(seqs)
            if best != ctx["best"]:
                raise SystemExit("sharded best hits differ from unsharded")
            print(f"sharded best hits: {len(best)} winners identical")
        warm = min(timed_ms(lambda: engine.scan(seqs)) / 1e3
                   for _ in range(2))
        print(f"warm scan {algo} (min of 2, CUDA events): sharded "
              f"{warm:.4f} s vs unsharded {ctx['warm'][semiring]:.4f} s, "
              f"{ctx['cells'] / warm / 1e9:.2f} GCUPS")
        out[semiring] = launches[semiring]
        del engine
        torch.cuda.empty_cache()
    return out


def phase_daemon(ctx, workdir: str) -> dict:
    """Per semiring: launches of the daemon's scan jobs."""
    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.server.daemon import Server
    from deciphon_tpu_torch.server.fake_sched import FakeScheduler
    from deciphon_tpu_torch.utils.config import ServerConfig

    db, seqs, planted = ctx["db"], ctx["seqs"], ctx["planted"]
    fake = FakeScheduler(spool_dir=os.path.join(workdir, "sched"))
    url = fake.serve()
    launches = dict.fromkeys(TOL, 0)
    try:
        cfg = ServerConfig(cache_dir=os.path.join(workdir, "daemon"),
                           api_url=url, single_run=True)
        server = Server(cfg, device="cuda")

        def run_job(job_id: int, what: str) -> float:
            t0 = time.perf_counter()
            if not server.run_one():
                raise SystemExit(f"daemon {what}: no job ran")
            job = fake.jobs[job_id]
            if job.state != "done":
                raise SystemExit(f"daemon {what} job {job.state}: "
                                 f"{job.error}")
            return time.perf_counter() - t0

        with open(ctx["hmm"], "rb") as fp:
            hmm = fake.add_hmm("pfam_shaped.hmm", fp.read())
        press_s = run_job(hmm.job_id, "press")
        t0 = time.perf_counter()
        server._join_prewarm()
        prewarm_s = time.perf_counter() - t0
        db_meta = next(iter(fake.dbs.values()))
        with open(fake.files[db_meta.filename], "rb") as a, \
                open(ctx["dtp"], "rb") as b:
            if a.read() != b.read():
                raise SystemExit("daemon .dtp differs from the CLI's")
        print(f"daemon press: {press_s:.2f} s, then {prewarm_s:.2f} s more "
              "for the prewarm thread (host clock); .dtp equals the CLI's "
              "byte for byte")

        records = [(s.name, s.data) for s in seqs]
        rows_of = {}
        for mode in ("scan", "best-hit"):
            if mode == "best-hit":
                os.environ["DCP_BEST_HIT"] = "1"
            try:
                scan = fake.add_scan(db_meta.id, records)
                reset_launches()
                job_s = run_job(scan.job_id, mode)
                for k, n in vc.LAUNCHES.items():
                    launches[k] += n
            finally:
                os.environ.pop("DCP_BEST_HIT", None)
            if vc.LAUNCHES["max"] == 0:
                raise SystemExit(f"daemon {mode}: no kernel launch")
            # the scheduler numbers this scan's reads in input order
            index = {q.id: i for i, q in enumerate(fake.seqs[scan.id])}
            rows_of[mode] = [
                (index[int(r[1])], r[2], float(r[4]), float(r[5]), r[8])
                for r in (ln.split("\t")
                          for ln in fake.products[-1].splitlines()[1:])
            ]
            print(f"daemon {mode}: {job_s:.2f} s (host clock), "
                  f"{len(rows_of[mode])} rows, {vc.LAUNCHES['max']} "
                  f"{KERNEL_NAME['max']} launches")
        acc = [db.profile(i).accession for i in range(db.nprofiles)]
        want = {
            "scan": [(h.seq_idx, h.accession, h.alt_loglik, h.null_loglik,
                      h.match) for h in ctx["hits"]],
            "best-hit": [
                (b.seq_id - 1, b.accession, b.alt_loglik, b.null_loglik, "")
                for b in ctx["best"] if b.lrt >= cfg.scan_lrt_threshold
            ],
        }
        for mode, rows in rows_of.items():
            ref = want[mode]
            if [(r[0], r[1], r[4]) for r in rows] != [
                (r[0], r[1], r[4]) for r in ref
            ]:
                raise SystemExit(f"daemon {mode} rows differ from the "
                                 "in-process engine's")
            for r, w in zip(rows, ref):
                for got, exp in zip(r[2:4], w[2:4]):
                    if abs(got - exp) > 1e-4 + 1e-6 * abs(exp):
                        raise SystemExit(f"daemon {mode} loglik {got} vs "
                                         f"{exp}")
            check_planted({(r[0] + 1, acc.index(r[1])) for r in rows},
                          planted, f"daemon {mode} ({len(rows)} rows)")
        print("daemon products equal the in-process hits and best hits")
    finally:
        fake.shutdown()
    return launches


def main(argv: list[str]) -> int:
    import torch

    menu_only = argv == ["--menu-only"]
    if argv and not menu_only:
        print("usage: chip_smoke.py [--menu-only]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from deciphon_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    clock = sm_clock_hz()
    t_start = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t_start:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS:.2f} s)")
    print(f"SM clock: {clock / 1e6:.0f} MHz (nvidia-smi clocks.max.sm)")
    for line in _build.BUILD_LOG.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill",
                                   "error")):
            print(f"  ptxas: {line.strip()}")
    menu_err = phase_kernel_menu(dev)
    print(f"menu done at {time.perf_counter() - t_start:.1f} s")
    if menu_only:  # phases 1-2: the build and the menu, then stop
        return 0
    # scratch for the synthetic DB and reads, inside the checkout
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        main_path, ctx = phase_main_path(dev, workdir, clock)
        print(f"main path done at {time.perf_counter() - t_start:.1f} s")
        sharded = phase_sharded(ctx)
        print(f"sharded done at {time.perf_counter() - t_start:.1f} s")
        daemon = phase_daemon(ctx, workdir)
        print(f"daemon done at {time.perf_counter() - t_start:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "deciphon_tpu"))
    if bad:
        raise SystemExit(f"imported {bad}")
    kernels = []
    for semiring, rec in main_path.items():
        rec["max_abs_err"] = max(rec["max_abs_err"], menu_err[semiring])
        per_path = dict(zip(PATHS, (rec["launches"], sharded[semiring],
                                    daemon[semiring])))
        kernels.append({
            "name": KERNEL_NAME[semiring], "route": "cuda",
            "source": KERNEL_SOURCE[semiring], "replaces": KERNEL_REPLACES,
            **rec,
            "paths": {k: n for k, n in per_path.items() if n},
        })
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
