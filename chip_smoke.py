#!/usr/bin/env python3
"""On-card smoke test of the deciphon_tpu_torch scan path (one NVIDIA GPU).

    python3 chip_smoke.py              # needs one CUDA card; ~8 min on an H100
    python3 chip_smoke.py --menu-only  # phases 1-2 and 3c, then stop
    python3 chip_smoke.py --trace-sweep [PARENT_TREE]
        # phase 1, the pass-2 menu, then the traceback plans' sweep:
        # trace_plan's plan against the alternatives of TRACE_SWEEP on the
        # same chunks; with PARENT_TREE (an unpacked checkout of the commit
        # of the first traceback design, e.g. `git archive 07a10f2`) its
        # csrc/traceback.cu too, on the menu's cells and the sweep's
        # chunks, in turns, then warm scans of phase 3's DB and reads by
        # that checkout's engine and by this one's, in turns

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
     1e-5 * |plain| (logsumexp).  Then pass 2's kernel (csrc/
     traceback.cu) against its plain version trace_dp on the card: K 8,
     40, 129, 385, 600, 1025, 2000, 2049 and 4096 (every row of the plan
     table: a CTA per hit, a cluster of 2 or 4 CTAs per hit) with reads of
     0-600 nt and one of 1200 nt, ragged cores, dead DD links and a
     tie-forcing profile; all four flag pairs at K 40; base-5 and base-6
     reads; 1 hit and 128 hits.  The kernel runs on tables of the card
     route (viterbi_trace.pack_chunk), which must be within one f32 ulp
     of the host block's (the count of entries apart printed), and
     trace_dp on the host block (build_profile_block).
     Every backpointer array must equal trace_dp's on the rows a walk
     reads (VT within the Viterbi tolerance; it has been 0) and the walked
     paths be identical; each cell prints its plan, kernel ms, us per
     position and share of its bound;
  3. the main path at a Pfam-shaped size: press a synthetic 1024-profile
     .hmm, then scan one mixed read set (256 ACGT reads, 24 reads with N,
     8 with N and R) under Viterbi and under --forward, each with the
     port's CLI (subprocess) and the same engine in process: planted
     reads (also those holding N, and N and R) must hit their profiles,
     the semiring's kernel must have been launched once per block and
     read class, and csrc/tables.cu once per block and class with IUPAC
     codes (tables.LAUNCHES), every pass-1 cell of every class must equal the plain
     version, and no jax may be loaded.  Pass 2 must have launched the
     traceback kernel once per chunk of each (width, class) group, waited
     on the card once (viterbi_trace.trace_scan), never called
     trace_dp, and built on the card the tables of every hit it queued
     (the recorded scan's counter trace_tables); replayed chunk by chunk
     (reads, the card route's pack, kernel, D2H copy, walk, codec, each
     timed, and the kernel's share of them) the card route's tables are
     within one f32 ulp of the host blocks', every array equals
     trace_dp's on the host blocks, on the card, and every hit's path and
     match string equal the replay's; then pass 2 runs once more as the
     scan runs it, trace_scan split into its parts (reads, pack, enqueue,
     the wait for the card, the copy, the walks) beside the codec.  Kernel-vs-plain times per class,
     warm scan seconds and GCUPS are timed with CUDA events, and each
     kernel's bound is computed from the same inputs: the larger of its
     bytes over 3.35 TB/s and its operations over the card's rates (see
     `bound`); the ACGT class under Viterbi also prints one line per
     block (width, profiles, launch plan, ms, share of its bound);
 3c. the extended tables of phase 3's DB, built from one store's
     resident inputs (uploaded once) for base 5 ("N") and base 6 ("N",
     "R"), each by csrc/tables.cu (one launch per block after the f64
     pattern-marginal product) and by synth_fragment_tables on the card:
     fm and fin within TABLES_ULPS units in the last place, with max
     |d|, launches, card time of each and the kernel's share of its
     bytes' floor; then two profiles' tables for seven codes, where the
     kernel reads the pattern marginals from device memory;
 3b. the cold start, on phase 3's DB and reads: per algorithm a fresh
     process (--cold-worker) with ScanEngine.warmup and one without,
     each printing host-clock seconds of import torch, the package,
     TensorDB.load, the CUDA context, the kernel library (with
     BUILD_SECONDS, 0 as the build is reused), the warmup's tables and
     launches, and the first and second scans, and the host seconds of
     each call of the pass-1 entry point (where CUDA's lazy loading
     loads an instantiation at its first launch); the warmup must launch
     the semiring's kernel once per block, and the first scan's calls
     after it must take no more than the second scan's plus
     LOAD_MARGIN_S.  The CLI scan without its warmup (--cli-nowarm) must
     write phase 3's warmed products byte for byte.  A fresh daemon
     (--cold-daemon) runs one scan job of a DB pressed by another
     process: job and spool seconds, and whether the warmup started
     during the spool ended inside it;
  4. the profile-sharded engine on the same DB and reads: a mesh over
     every visible card, or on one card ["cuda:0"] * 4 as 2 read shards x
     2 profile shards.  Viterbi and forward scans and best hits: every
     pass-1 cell of every class must equal the unsharded engine's bit for
     bit, the hits and best-hit winners must be identical, the kernel
     must have been launched tiles x blocks x classes times, and pass 2
     the traceback kernel once per chunk, with one host wait;
  5. the scheduler daemon, Server(device="cuda"), against the port's
     FakeScheduler on localhost: a press job of the same .hmm (the
     uploaded .dtp must equal the CLI's byte for byte), a scan job of the
     288 reads and a DCP_BEST_HIT=1 scan job, whose products must equal
     phase 3's in-process hits (logliks within 1e-4 + 1e-6 * |x|) and
     best hits; every planted read must hit, the kernel must have been
     launched, and the scan job's pass 2 the traceback kernel, with one
     host wait (none in the best-hit job).  A failed job is fatal;
  6. the multi-process scan (parallel/distributed.py): two worker
     processes (this script with --dist-worker) join a gloo process group
     on a free localhost port (DCP_COORDINATOR, DCP_NUM_PROCS=2,
     DCP_PROC_ID), each on cuda:0 (one card) or a card of its own.  Each
     runs worker_parity_check(), then scores its profile shard of phase
     3's DB against phase 3's 256 ACGT reads under Viterbi through
     global_viterbi_scores: every cell must equal phase 3's unsharded
     kernel cell bit for bit, the two ranks together must cover every
     cell once, and each rank must have launched the Viterbi kernel;
  7. the host entry points and the trace: a standard (typeid-1) DB
     scanned through the CLI with --device cuda, every row equal to
     scan_standard's on the CPU (logliks within 1e-5); `info` on a
     synthetic reference .dcp and `parity` on a synthetic .hmm (PARITY
     OK); then one warm Viterbi scan of 32 of phase 3's reads with
     DCP_PROFILE_DIR set: the Chrome trace must exist and name the
     Viterbi and traceback kernels, and its kernel time by name and the
     device's idle share of the traced window are printed.
The last two lines are the card line and a JSON {"ok": true, ...}; the
line before them is the JSON kernel table, which lists per kernel the
launches of each path (scan, sharded, daemon, distributed, traced,
cold: phase 3b's processes) beside phase 3's; the traceback row's
launches, times and bound are those of phase 3's two scans, the
tables row's launches those of phase 3's two scans and its times,
error and bound phase 3c's.
"""

from __future__ import annotations

import contextlib
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
# pass 2's kernel (csrc/traceback.cu, ops/viterbi_trace.launch_trace)
TRACE_NAME = "traceback"
TRACE_SOURCE = "deciphon_tpu_torch/csrc/traceback.cu"
TRACE_REPLACES = "deciphon_tpu/ops/viterbi_trace.py:266"
# its menu (phase 2): widths, with reads of MENU_LENS and one long read;
# every row of viterbi_trace.TRACE_TABLE: CTA plans of 1 and 2 nodes a
# thread (K 8, 40, 129, 385; 600), clusters of 2 CTAs of 2 and 4 nodes a
# thread (1025; 2000) and of 4 CTAs of 2 (2049, 4096)
TRACE_MENU_K = (8, 40, 129, 385, 600, 1025, 2000, 2049, 4096)
TRACE_LONG_NT = 1200
TRACE_H128_K = 129  # the cell of a full chunk: TRACE_BATCH hits
TRACE_H1_K = 385  # the cell of one hit
# pass 2's work per (hit, position, core node), as ops/viterbi_trace.
# trace_dp writes it: match 20 candidates of 2 adds each and 19
# comparisons; insert 10 of 2 adds and 9 comparisons; the D-chain's a
# (an add, a subtraction), its prefix max, cdd + b and the NEG clamp, and
# the dD comparison; E's two slots (M and D).  The specials are per (hit,
# position), not per node, and are left out as in MAX_OPS.
TRACE_OPS = (40 + 19) + (20 + 9) + 6 + 2
# phase 3c: the extended tables' kernel (csrc/tables.cu) against the
# torch synthesis it replaces on the card; both add the same f32 terms
# in the same order, so only logf's rounding may differ
TABLES_NAME = "tables"  # ops/tables.LAUNCHES' key and the table's row
TABLES_SOURCE = "deciphon_tpu_torch/csrc/tables.cu"
TABLES_REPLACES = ("none: the torch synthesis of ops/tables.py "
                   "(deciphon_tpu/ops/tables.py in XLA)")
TABLES_ULPS = 2
TABLES_WIDE = tuple("NRYSWKM")  # the kernel's other instantiation
# the paths of phases 3-7 and 3b, in the kernel table's "paths"
PATHS = ("scan", "sharded", "daemon", "distributed", "traced", "cold")
# phase 3b: how much longer the first scan's pass-1 launch calls may take
# than the second's after the warmup (host clock).  CUDA loads the kernel
# library's module at the first launch into it (3-15 ms on an H100
# machine) and each further instantiation at its own first launch (0.04-
# 0.85 ms); warm calls take 0.01-0.08 ms, and the 39 calls of a scan
# spread by under 0.5 ms between scans.  The margin catches the module
# load or about ten missed instantiations, not one.
LOAD_MARGIN_S = 2e-3
NPROCS = 2  # phase 6's worker processes
TRACE_READS = 32  # phase 7's traced scan
# phase 7's standard DB: profiles and their state counts, and reads
STD_PROFILES, STD_STATES, STD_READS = 64, (2, 12), 32


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


def tie_profile(K: int):
    """K identical nodes with flat amino emissions and flat transition
    rows: equal candidates across lengths, origins and nodes."""
    from deciphon_tpu_torch.models import profile as mp

    flat = np.full(20, -np.log(20.0))
    b = mp.ProteinModelBuilder(mp.ProteinCfg(), null_lprobs=flat)
    b.setup(K)
    for i in range(K + 1):
        row = np.full(7, -np.log(7.0))
        if i == 0:
            row[mp.TRANS_DD] = mp.LOG0
        if i == K:
            row[mp.TRANS_MD] = row[mp.TRANS_DD] = mp.LOG0
        live = np.isfinite(row)
        row[live] = -np.log(live.sum())
        b.add_trans(row)
        if i < K:
            b.add_node(flat, "-")
    return b.finalize(accession=f"ties-{K}")


def trace_cells():
    """(label, width, hits [(profile, read)], codes, flag pairs) of the
    pass-2 menu: per width of TRACE_MENU_K, reads of MENU_LENS (an empty
    one among them) and one of TRACE_LONG_NT nt against ragged cores, a
    profile with two dead DD links and a tie-forcing one; base-5 and
    base-6 reads at K 129; one hit at K 385; TRACE_BATCH hits at K
    129."""
    from deciphon_tpu_torch.models.profile import sample_profile
    from deciphon_tpu_torch.ops.viterbi_trace import TRACE_BATCH

    rng = np.random.default_rng(13)

    def long_read(codes):
        r = list(rng.choice(list("ACGT"), TRACE_LONG_NT))
        if codes:
            r[3], r[TRACE_LONG_NT // 2] = codes[0], codes[-1]
        return "".join(r)

    def profiles(K):
        cores = sorted({K, max(2, K - 5), max(2, K // 2), max(2, K // 3)})
        profs = [sample_profile(300 * K + j, k) for j, k in enumerate(cores)]
        dd = profs[-1].dd_in.copy()
        dd[[K // 3, 2 * K // 3]] = -np.inf
        return profs + [replace(profs[-1], dd_in=dd),
                        tie_profile(max(2, K - 1))]

    cells = []
    for K in TRACE_MENU_K:
        profs = profiles(K)
        reads = menu_reads(()) + [long_read(())]
        hits = [(profs[j % len(profs)], r) for j, r in enumerate(reads)]
        cells.append((f"K={K}", K, hits, (), FLAGS if K == 40 else EXT_FLAGS))
    for codes in EXT_CODES:
        profs = profiles(129)
        reads = menu_reads(codes) + [long_read(codes)]
        hits = [(profs[j % len(profs)], r) for j, r in enumerate(reads)]
        cells.append((f"K=129 {'+'.join(codes)}", 129, hits, codes,
                      EXT_FLAGS))
    cells.append((f"H=1 K={TRACE_H1_K} ties", TRACE_H1_K,
                  [(tie_profile(TRACE_H1_K), long_read(())[:600])], (),
                  EXT_FLAGS))
    profs = profiles(TRACE_H128_K)
    hits = [(profs[j % len(profs)],
             "".join(rng.choice(list("ACGT"), int(rng.integers(150, 500)))))
            for j in range(TRACE_BATCH)]
    cells.append((f"H={TRACE_BATCH} K={TRACE_H128_K}", TRACE_H128_K, hits,
                   (), EXT_FLAGS))
    return cells


def phase_trace_menu(dev, clock: float) -> float:
    """The traceback kernel against trace_dp on the card over the menu
    of ``trace_cells``, the kernel on tables of the card route
    (viterbi_trace.pack_chunk) and trace_dp on the host block
    (build_profile_block): the tables within one f32 ulp (the count of
    entries apart printed), every backpointer array equal on the rows a
    walk reads (rows < seq_len), VT within the Viterbi tolerance, walked
    paths identical; one timing line per cell (kernel ms, the min of 3
    CUDA-event runs, us per position, share of the bound).  Every (kind,
    npt) of the plan table must have been launched.  Returns the worst
    |VT - plain VT|."""
    import torch

    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    worst, ncells, nwalks, kernels = 0.0, 0, 0, set()
    entries = apart = most = 0
    for label, K, hits, codes, flags in trace_cells():
        profs = [p for p, _ in hits]
        encs = [encode(r, codes) for _, r in hits]
        plan = vtr.trace_plan(K)
        for (chunk_p, eidx, lens), (block, _, _) in zip(
                vtr.chunk_reads(profs, encs, codes or None),
                vtr.chunks(profs, encs, K, codes or None), strict=True):
            for mh, h3 in flags:
                pk = vtr.pack_chunk(chunk_p, eidx, lens, K, codes, mh, h3,
                                    dev)
                if (mh, h3) == flags[0]:  # the tables take no flags
                    n, bad, top = table_ulps(pk, block)
                    if top > 1:
                        raise SystemExit(f"trace menu {label}: card tables "
                                         f"{top} ulp from the host block's")
                    entries, apart = entries + n, apart + bad
                    most = max(most, top)
                out = []
                k_ms = timed_ms(lambda: out.append(vtr.launch_trace(pk)),
                                reps=3)
                kernels.add((plan.kind, plan.npt))
                ys = out[0].host()
                t0 = time.perf_counter()
                _, pys = vtr.trace_dp(block, eidx, lens, mh, h3, dev)
                p_s = time.perf_counter() - t0
                what = (f"trace menu {label} multi_hits={mh} "
                        f"hmmer3_compat={h3}")
                d = compare_ys(ys, pys, lens, what)
                walks = compare_paths(ys, pys, lens, K, what)
                same = all(np.array_equal(ys[k], pys[k]) for k in vtr.YS)
                Lmax = pk.eidx.shape[1]
                b_ms, b_by = bound(*trace_work(block, eidx, lens),
                                   "trace", clock)
                print(f"{what}: H={len(lens)} ntab="
                      f"{pk.fmT.shape[1]} Lmax={Lmax} plan "
                      f"{trace_plan_str(plan)}: card tables {bad} of {n} "
                      f"entries apart from the host block's, at most {top} "
                      f"ulp; codes equal, VT max|d| "
                      f"{d:.3g}, {walks} paths identical; all rows equal "
                      f"(past seq_len too): {same}; kernel {k_ms:.3f} ms "
                      f"(CUDA events, min of 3), "
                      f"{1e3 * k_ms / max(Lmax, 1):.3f} us a position, "
                      f"{100 * b_ms / k_ms:.3f}% of its bound ({b_ms:.5f} "
                      f"ms by {b_by}) vs trace_dp {p_s:.3f} s (host clock)")
                worst = max(worst, d)
                ncells += 1
                nwalks += walks
                del pk, out
        torch.cuda.empty_cache()
    if kernels != set(vtr.TRACE_KERNELS):
        raise SystemExit(f"trace menu: {sorted(kernels)} launched, want "
                         f"every (kind, npt) of the plan table "
                         f"{sorted(vtr.TRACE_KERNELS)}")
    print(f"trace menu: all {ncells} cells equal trace_dp, {nwalks} paths "
          f"identical, VT max|d| {worst:.3g}; card tables {apart} of "
          f"{entries} entries apart from the host blocks', at most {most} "
          f"ulp; plans launched: "
          f"{', '.join(f'{k}/npt{n}' for k, n in sorted(kernels))}")
    trace_code_sets(dev)
    return worst


# read classes of more codes than the menu's, for pass 2's tables on the
# card: their coefficient matrices (5.1 GB for three codes) go up a
# column slice at a time
TRACE_CODE_SETS = (("N", "R", "Y"),)


def trace_code_sets(dev) -> None:
    """Pass 2 on the card for each read class of TRACE_CODE_SETS: a
    chunk of four hits (cores 20-90, reads of 60-150 nt with every code)
    packed by the card route, its tables within one f32 ulp of the host
    block's and the kernel's arrays and paths equal to trace_dp's on the
    host block; the device memory the pack holds above what was held
    before it (torch's peak) must stay within its outputs, its rows, a
    row slice and two column slices of the coefficient matrix
    (TABLE_SLICE_BYTES each).  Prints the peak, the host matrix's bytes
    and the pack's time (host clock, card synchronized) against the host
    block's."""
    import torch

    from deciphon_tpu_torch.models import frame
    from deciphon_tpu_torch.models.profile import sample_profile
    from deciphon_tpu_torch.ops import viterbi_trace as vtr
    from deciphon_tpu_torch.ops.viterbi_torch import build_profile_block

    rng = np.random.default_rng(29)
    for codes in TRACE_CODE_SETS:
        cores = [20, 47, 64, 90]
        profs = [sample_profile(900 + j, k) for j, k in enumerate(cores)]
        reads = []
        for j in range(len(profs)):
            r = list(rng.choice(list("ACGT"), int(rng.integers(60, 151))))
            for i, c in enumerate(codes):
                r[7 * i + j] = c
            reads.append("".join(r))
        encs = [encode(r, codes) for r in reads]
        K = max(cores)
        ((chunk_p, eidx, lens),) = vtr.chunk_reads(profs, encs, codes)
        t0 = time.perf_counter()
        block = build_profile_block(profs, kpad=K, codes=codes)
        host_s = time.perf_counter() - t0
        vtr.pack_chunk(chunk_p, eidx, lens, K, codes, True, False, dev)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pk = vtr.pack_chunk(chunk_p, eidx, lens, K, codes, True, False, dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - held
        outs = sum(x.numel() * x.element_size() for x in pk[:5])
        room = (outs + vtr._rows_bytes(chunk_p, codes) + vtr.TABLE_SLICE_BYTES
                + vtr._coef_bytes(codes))
        what = f"pass 2 tables of {'+'.join(codes)}"
        n, bad, top = table_ulps(pk, block)
        if top > 1:
            raise SystemExit(f"{what}: card tables {top} ulp from the host "
                             "block's")
        if peak > room:
            raise SystemExit(f"{what}: the pack held {peak} B on the card "
                             f"above what was held, over its {room} B")
        ys = vtr.launch_trace(pk).host()
        _, pys = vtr.trace_dp(block, eidx, lens, True, False, dev)
        d = compare_ys(ys, pys, lens, what)
        walks = compare_paths(ys, pys, lens, K, what)
        C = frame.ext_fragment_matrix(profs[0].cfg.epsilon, codes)
        print(f"{what}: {bad} of {n} entries apart from the host block's, "
              f"at most {top} ulp; {walks} paths identical, VT max|d| "
              f"{d:.3g}; pack peak {peak} B above {held} B held (room "
              f"{room} B; host matrix {C.nbytes} B in "
              f"{-(-C.shape[1] // vtr._col_step(codes))} column slices); "
              f"card route {card_s:.4f} s vs host block {host_s:.4f} s "
              f"(host clock, {len(profs)} hits, {sum(cores)} nodes)")
        del pk, C
        torch.cuda.empty_cache()


def trace_plan_str(p) -> str:
    """A traceback launch plan in a few characters: kind, nodes a
    thread, warps per CTA x CTAs per hit."""
    return f"{p.kind}/npt{p.npt}/w{p.warps}x{p.cluster}"


# the traceback plans' sweep (--trace-sweep): per width, hits and read
# length of a chunk, the (kind, nodes a thread) alternatives of
# viterbi_trace._plan to time against trace_plan's: at K 64-160 the main
# path's shapes (1-4 hits of 150-500 nt, and a full chunk of 128 hits),
# then each row's boundaries and the widths between the cluster rows
TRACE_SWEEP = (
    (64, 4, 400, (("cta", 2),)),
    (160, 4, 400, (("cta", 2),)),
    (129, 128, 400, (("cta", 2),)),
    (384, 4, 400, (("cta", 2),)),
    (1024, 4, 1200, (("cluster", 2),)),
    (1025, 4, 1200, (("cluster", 4),)),
    (1280, 4, 1200, (("cluster", 4),)),
    (1536, 4, 1200, (("cluster", 4),)),
    (1792, 4, 1200, (("cluster", 4),)),
    (2048, 4, 1200, (("cluster", 2),)),
    (4096, 4, 1200, (("cluster", 4),)),
)


def first_design(parent: str):
    """(launch, plan) of the first traceback design, built from the
    csrc/traceback.cu of ``parent`` (an unpacked checkout of the commit
    that holds it): one CTA per hit, 1-8 nodes a thread, rings in shared
    memory or, above K ~3400, in device-memory scratch."""
    import ctypes
    import tempfile

    import torch

    from deciphon_tpu_torch.ops import _build
    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    out = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    so = os.path.join(out, "baseline.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                    os.path.join(parent, TRACE_SOURCE)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(so).dcp_traceback
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 5 + [f, f] + [p] * 11 + [i] * 8 + [p]
    fn.restype = i

    def plan(K):
        npt = next(n for n in (1, 2, 4, 8) if K <= n * 512)
        ring = 4 * (15 * (K + 1) + 2 * (K + 2)) <= vtr.SMEM_MAX
        smem = 4 * ((15 * (K + 1) if ring else 0) + 2 * (K + 2))
        return npt, 32 * -(-K // (32 * npt)), smem, int(ring)

    def launch(pk):
        H, ntab, K = pk.fmT.shape
        Lmax = pk.eidx.shape[1]
        views, nbytes = vtr._layout(Lmax, H, K)
        buf = torch.empty(nbytes, dtype=torch.uint8, device=pk.fmT.device)
        npt, threads, smem, ring = plan(K)
        scratch = (None if ring else torch.empty(
            (H, 15, K + 1), dtype=torch.float32, device=pk.fmT.device))
        rc = fn(pk.fmT.data_ptr(), pk.fin.data_ptr(), pk.planes.data_ptr(),
                pk.eidx.data_ptr(), pk.sp.data_ptr(), ctypes.c_float(pk.EJ),
                ctypes.c_float(pk.EC),
                0 if scratch is None else scratch.data_ptr(),
                *(buf.data_ptr() + views[k][0] for k in vtr.YS), H, K, ntab,
                Lmax, npt, threads, smem, ring,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"baseline launch failed: "
                             f"{_build.error_string(rc)}")
        return vtr.TraceOut(buf, views)

    return launch, plan


def sweep_chunk(K: int, H: int, nt: int, rng):
    """A chunk of H hits at width K: ragged cores up to K, reads of nt."""
    from deciphon_tpu_torch.models.profile import sample_profile
    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    profs = [sample_profile(700 * K + j, int(k)) for j, k in enumerate(
        rng.integers(max(2, K // 2), K + 1, H))]
    encs = [encode("".join(rng.choice(list("ACGT"), nt)), ())
            for _ in range(H)]
    ((block, eidx, lens),) = vtr.chunks(profs, encs, K)
    return profs, block, eidx, lens


def phase_trace_sweep(dev, clock: float, parent: str | None) -> None:
    """The traceback plans on the card: per TRACE_SWEEP chunk trace_plan's
    plan and its alternatives, each held equal to the plan's arrays and
    timed (CUDA events, min of 3, in turns plan / alternative /
    alternative / plan); with ``parent`` the first design on the same
    chunks and on the pass-2 menu's cells (one flag pair), in turns
    first design / this / this / first design, its arrays equal too."""
    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    base = first_design(parent) if parent else None
    rng = np.random.default_rng(17)

    def same(a, b, what):
        for k in vtr.YS:
            if not np.array_equal(a[k], b[k]):
                raise SystemExit(f"{what}: {k} differs")

    def turns(f, g):
        """(f ms, g ms): min of 3 CUDA-event runs each, in turns."""
        tf, tg = [], []
        for fn, acc in ((f, tf), (g, tg), (g, tg), (f, tf), (f, tf),
                        (g, tg)):
            acc.append(timed_ms(fn))
        return min(tf), min(tg)

    def pack(profs, eidx, lens, K, codes=()):
        return vtr.pack_chunk(profs, eidx, lens, K, codes, True, False, dev)

    for K, H, nt, alts in TRACE_SWEEP:
        profs, block, eidx, lens = sweep_chunk(K, H, nt, rng)
        pk = pack(profs, eidx, lens, K)
        b_ms, b_by = bound(*trace_work(block, eidx, lens), "trace",
                           clock)
        plan = vtr.trace_plan(K)
        ref = vtr.launch_trace(pk).host()
        line = [f"sweep K={K} H={H} Lmax={nt}: bound {b_ms:.5f} ms by "
                f"{b_by}"]
        for kind, npt in alts:
            alt = vtr._plan(kind, npt, K)
            same(vtr._launch(pk, None, alt).host(), ref,
                 f"sweep K={K} {trace_plan_str(alt)}")
            d_ms, a_ms = turns(lambda: vtr.launch_trace(pk),
                               lambda: vtr._launch(pk, None, alt))
            line.append(f"{trace_plan_str(plan)} {d_ms:.3f} ms vs "
                        f"{trace_plan_str(alt)} {a_ms:.3f} ms")
        if base:
            same(base[0](pk).host(), ref, f"sweep K={K} first design")
            f_ms, d_ms = turns(lambda: base[0](pk),
                               lambda: vtr.launch_trace(pk))
            line.append(f"first design {f_ms:.3f} ms vs "
                        f"{trace_plan_str(plan)} {d_ms:.3f} ms "
                        f"({f_ms / d_ms:.1f}x; {100 * b_ms / d_ms:.3f}% of "
                        f"the bound)")
        print("; ".join(line))
    if not base:
        return
    for label, K, hits, codes, flags in trace_cells():
        profs = [p for p, _ in hits]
        encs = [encode(r, codes) for _, r in hits]
        for (chunk_p, eidx, lens), (block, _, _) in zip(
                vtr.chunk_reads(profs, encs, codes or None),
                vtr.chunks(profs, encs, K, codes or None), strict=True):
            pk = pack(chunk_p, eidx, lens, K, codes)
            same(base[0](pk).host(), vtr.launch_trace(pk).host(),
                 f"menu {label} first design")
            f_ms, d_ms = turns(lambda: base[0](pk),
                               lambda: vtr.launch_trace(pk))
            b_ms, _ = bound(*trace_work(block, eidx, lens), "trace",
                            clock)
            print(f"first design vs this, menu {label} H={len(lens)} Lmax="
                  f"{pk.eidx.shape[1]}: {f_ms:.3f} ms vs "
                  f"{trace_plan_str(vtr.trace_plan(K))} {d_ms:.3f} ms "
                  f"({f_ms / d_ms:.1f}x), {1e3 * d_ms / pk.eidx.shape[1]:.3f}"
                  f" us a position, {100 * b_ms / d_ms:.3f}% of the bound")


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


def cli(*args, warm: bool = True) -> str:
    """Run the port's CLI in a subprocess; its stdout.  ``warm=False``
    runs it through ``cli_nowarm`` (--cli-nowarm), with the engine's
    warmup a no-op."""
    t0 = time.perf_counter()
    cmd = ([sys.executable, "-m", "deciphon_tpu_torch.cli.main"] if warm
           else [sys.executable, os.path.abspath(__file__), "--cli-nowarm"])
    proc = subprocess.run([*cmd, *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(
            f"cli {args[0]} failed ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    print(f"cli {args[0]}{'' if warm else ' (no warmup)'}: "
          f"{time.perf_counter() - t0:.4f} s (host clock): "
          f"{proc.stdout.strip().splitlines()[-1]}")
    return proc.stdout


def cli_nowarm(args: list[str]) -> int:
    """The port's CLI with ScanEngine.warmup a no-op (--cli-nowarm): the
    cold start as it was before the CLI warmed its first batch."""
    from deciphon_tpu_torch.cli.main import main as cli_main
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine

    ScanEngine.warmup = lambda self, nseqs, max_len: 0.0
    return cli_main(args)


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
    for Viterbi ("max") and the traceback DP ("trace") its f32
    instructions at the issue rate; for forward the larger of its f32
    time (FMAs at PEAK_F32 as two operations each, other f32
    instructions at the issue rate) and its MUFU time."""
    if semiring == "max":
        return MAX_OPS / (SMS * F32_LANES * clock)
    if semiring == "trace":
        return TRACE_OPS / (SMS * F32_LANES * clock)
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
    from deciphon_tpu_torch.ops import tables
    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    for k in vc.LAUNCHES:
        vc.LAUNCHES[k] = 0
    vtr.LAUNCHES[TRACE_NAME] = 0
    vtr.HOST_WAITS["pass2"] = 0
    tables.LAUNCHES[TABLES_NAME] = 0


def table_launches() -> int:
    """csrc/tables.cu launches since reset_launches."""
    from deciphon_tpu_torch.ops import tables

    return tables.LAUNCHES[TABLES_NAME]


def ext_slices(engine, classes) -> int:
    """Profile slices a scan of ``classes`` builds extended tables in
    (Tables.slices, per profile shard on a mesh): one table launch each.
    At the smoke DB's size one a block (a shard on a mesh) and class."""
    return sum(len(engine.tables.slices(b, codes))
               for codes in classes if codes for b in engine.blocks)


def check_table_launches(got: int, want: int, what: str) -> int:
    """``got`` table launches must be ``want``: one per profile slice of
    an extended block (or profile shard) of each class with IUPAC codes
    (``ext_slices``); a scan that falls back to synth_fragment_tables
    launches none."""
    if got != want:
        raise SystemExit(f"{what}: {got} {TABLES_NAME} launches, want "
                         f"{want} (extended slices x classes with codes)")
    return got


def check_sliced_scan(engine, seqs, classes, hits, semiring: str,
                      what: str) -> int:
    """Scan ``seqs`` again with EXT_SLICE_BYTES a quarter of the largest
    extended block's tables, so that the widest blocks are cut into
    profile slices: every pass-1 cell must equal the whole blocks' scan
    bit for bit, the hits (scores, paths, match strings) be identical,
    and the launches be one table launch a slice and one kernel launch a
    slice or base-4 block.  Returns the slices."""
    from deciphon_tpu_torch.ops import scan_engine as se
    from deciphon_tpu_torch.ops import tables
    from deciphon_tpu_torch.ops import viterbi_cuda as vc

    whole = [a.copy() for a in engine.last_scores]
    ext = [codes for codes in classes if codes]
    largest = max(tables.table_bytes(c, b.kpad) * len(b.chunk)
                  for c in ext for b in engine.blocks)
    keep = se.EXT_SLICE_BYTES
    se.EXT_SLICE_BYTES = largest // 4
    try:
        n = ext_slices(engine, classes)
        cut = n - len(engine.blocks) * len(ext)
        reset_launches()
        got = engine.scan(seqs)
        launches = dict(vc.LAUNCHES)
    finally:
        se.EXT_SLICE_BYTES = keep
    check_table_launches(table_launches(), n, f"{what}, sliced")
    want = n + len(engine.blocks) * (len(classes) - len(ext))
    if cut <= 0 or launches[semiring] != want:
        raise SystemExit(f"{what}, sliced: {launches} launches for {n} "
                         f"slices ({cut} more than blocks), want {want} "
                         f"{semiring}")
    for name, a, b in zip(("alt", "null"), whole, engine.last_scores):
        if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
            raise SystemExit(f"{what}, sliced: pass-1 {name} differs from "
                             "the whole blocks' scan")
    if [vars(h) for h in got] != [vars(h) for h in hits]:
        raise SystemExit(f"{what}, sliced: hits differ from the whole "
                         "blocks' scan")
    print(f"sliced scan: {n} table launches for {n} slices ({cut} more "
          f"than blocks x classes with codes, at {largest // 4} B a "
          f"slice); every pass-1 cell bit-equal and {len(got)} hits "
          "identical to the whole blocks'")
    return n


def trace_waits() -> int:
    """Host waits of pass 2 since reset_launches (one per scan)."""
    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    return vtr.HOST_WAITS["pass2"]


def trace_launches() -> int:
    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    return vtr.LAUNCHES[TRACE_NAME]


def trace_work(block, eidx, lens) -> tuple[int, int]:
    """(bytes, (node, position) cells) of one traceback launch, over its
    hits: the fragment rows each read's positions gather, the planes,
    eidx and specials once, and the codes written (3 B per core
    node-position, 28 B per hit-position); cells are core nodes x read
    length."""
    core = np.asarray(block.core_size)
    nbytes = cells = 0
    for h in range(len(lens)):
        L, k = int(lens[h]), int(core[h])
        rows = len(np.unique(eidx[h, :L]))
        nbytes += 4 * (rows * (k + 2) + 9 * k + 5 * L + 2) + L * (3 * k + 28)
        cells += L * k
    return nbytes, cells


def compare_ys(ys, pys, lens, what: str) -> float:
    """max |VT - plain VT| over rows < seq_len; every code array must
    equal the plain version's there, and VT within the Viterbi
    tolerance."""
    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    worst = 0.0
    for k in vtr.YS:
        for h, L in enumerate(lens):
            got, want = ys[k][:L, h], pys[k][:L, h]
            if k == "VT":
                if not L:
                    continue
                d = np.abs(got.astype(np.float64) - want)
                if (d > TOL["max"][0] + TOL["max"][1] * np.abs(want)).any():
                    raise SystemExit(f"{what}: VT of hit {h} off plain, "
                                     f"max|d| {d.max()}")
                worst = max(worst, float(d.max()))
            elif not np.array_equal(got, want):
                bad = np.argwhere(got != want)[0]
                raise SystemExit(f"{what}: {k} of hit {h} differs from "
                                 f"trace_dp at row {bad[0]}")
    return worst


def compare_paths(ys, pys, lens, K: int, what: str) -> int:
    """Walk both versions' codes for the hits of non-empty reads; the
    paths must be identical.  Returns the walks compared."""
    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    n = 0
    for h in range(len(lens)):
        L = int(lens[h])
        if not L:  # an empty read never survives the gate
            continue
        got = vtr.walk({k: v[:, h] for k, v in ys.items()}, L, K)
        want = vtr.walk({k: v[:, h] for k, v in pys.items()}, L, K)
        if got != want:
            raise SystemExit(f"{what}: walked path of hit {h} differs")
        n += 1
    return n


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


@contextlib.contextmanager
def counting_trace_dp():
    """Counts calls of trace_dp, the traceback's plain version, while
    the block runs: the main path on a card must make none."""
    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    real, calls = vtr.trace_dp, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    vtr.trace_dp = counted
    try:
        yield calls
    finally:
        vtr.trace_dp = real


def trace_chunks(engine) -> int:
    """Traceback launches the engine's last scan should have made: one
    per chunk of TRACE_BATCH hits of each (width, read class) group."""
    from deciphon_tpu_torch.ops.viterbi_trace import TRACE_BATCH

    return sum(-(-len(items) // TRACE_BATCH) for items in
               engine.trace_groups(engine.last_survivors).values())


def check_trace_launches(engine, plain_calls: int, what: str) -> int:
    """The scan's pass 2 ran the kernel once per chunk, queued every
    chunk before one host wait, never called trace_dp, and built on the
    card the tables of every hit it queued (the recorded scan's counter
    ``trace_tables``); returns its launches."""
    n, want = trace_launches(), trace_chunks(engine)
    tables = engine.last_counts.get("trace_tables")
    queued = len(engine.last_survivors)
    if (n != want or not n or plain_calls or trace_waits() != 1
            or tables != queued):
        raise SystemExit(f"{what}: {n} {TRACE_NAME} launches, want {want} "
                         f"(> 0), {trace_waits()} host waits (want 1), "
                         f"{plain_calls} trace_dp calls (want 0) and "
                         f"trace_tables {tables} (want the {queued} hits "
                         "queued)")
    return n


def trace_scan_parts(engine, seqs) -> dict:
    """Host seconds of pass 2 over the engine's last survivors, run as
    the scan runs it (ScanEngine._traceback: trace_scan, then the codec),
    split into trace_scan's parts: the chunks' reads (chunk_reads), their
    pack (pack_chunk: rows, transitions and uploads on the host, the
    tables queued on the card), enqueue
    (launch_trace), the wait for the work still running after the last
    launch and the one copy back (_to_host), the walks; the rest of
    trace_scan (layout, streams, results), the codec and the whole."""
    import torch

    from deciphon_tpu_torch.ops import viterbi_trace as vtr

    t = dict.fromkeys(("build", "pack", "enqueue", "wait", "copy", "walk",
                       "trace_scan"), 0.0)
    build, pack = "chunk_reads", "pack_chunk"
    real = {n: getattr(vtr, n) for n in (
        build, pack, "launch_trace", "_to_host", "walk", "trace_scan")}

    def timed(name):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return real[name](*a, **k)
            finally:
                t[key[name]] += time.perf_counter() - t0
        return run

    def chunks(*a, **k):
        it = real[build](*a, **k)
        while True:
            t0 = time.perf_counter()
            try:
                c = next(it)
            except StopIteration:
                return
            finally:
                t["build"] += time.perf_counter() - t0
            yield c

    def to_host(*a, **k):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        raw = real["_to_host"](*a, **k)
        t["wait"] += t1 - t0
        t["copy"] += time.perf_counter() - t1
        return raw

    key = {pack: "pack", "launch_trace": "enqueue", "walk": "walk",
           "trace_scan": "trace_scan"}
    encoded, _ = engine.encode(seqs)
    waits = vtr.HOST_WAITS["pass2"]
    try:
        setattr(vtr, build, chunks)
        vtr._to_host = to_host
        for n in key:
            setattr(vtr, n, timed(n))
        t0 = time.perf_counter()
        engine._traceback(seqs, encoded, engine.last_survivors)
        t["pass2"] = time.perf_counter() - t0
    finally:
        for n, f in real.items():
            setattr(vtr, n, f)
    t["waits"] = vtr.HOST_WAITS["pass2"] - waits
    t["codec"] = t["pass2"] - t["trace_scan"]
    t["other"] = t["trace_scan"] - sum(
        t[k] for k in ("build", "pack", "enqueue", "wait", "copy", "walk"))
    return t


def parts_line(t: dict) -> str:
    """``trace_scan_parts``'s seconds on one line."""
    return (f"{t['pass2']:.4f} s (host clock): trace_scan "
            f"{t['trace_scan']:.4f} s = reads (or block) build "
            f"{t['build']:.4f} + pack and upload {t['pack']:.4f} + enqueue "
            f"{t['enqueue']:.4f} + wait for the card {t['wait']:.4f} + copy "
            f"{t['copy']:.4f} + "
            f"walks {t['walk']:.4f} + other {t['other']:.4f} s "
            f"({t['waits']} host wait), codec {t['codec']:.4f} s")


def pass2_replay(engine, seqs, hits, dev, clock, what: str) -> dict:
    """Pass 2 of the engine's last scan, replayed chunk by chunk through
    the pieces of trace_scan, each timed: the chunk's reads (eidx), its
    pack by the card route (pack_chunk: host rows, uploads, the tables
    on the card), kernel (CUDA events), D2H copy, walk, codec; then the
    host block of the CPU route (build_profile_block) and trace_dp on
    the card on it.  The card route's tables must be within one f32 ulp
    of the host block's (the count of entries apart printed), every
    array equal trace_dp's, the paths be identical, and each survivor's
    path and match string equal the scan's hit.  Then pass 2 once more
    as the scan runs it, split by ``trace_scan_parts``."""
    import torch

    from deciphon_tpu_torch.models import codec
    from deciphon_tpu_torch.ops import viterbi_trace as vtr
    from deciphon_tpu_torch.ops.viterbi_torch import build_profile_block

    p = engine.params
    encoded, _ = engine.encode(seqs)
    by_pair = {(h.seq_idx, h.profile_idx): h for h in hits}
    t = dict.fromkeys(("build", "pack", "d2h", "walk", "codec",
                       "host_block", "plain"), 0.0)
    rec = dict(kernel_ms=0.0, worst=0.0, nbytes=0, cells=0, chunks=0,
               hits=0, block_bytes=0, groups=[], entries=0, apart=0,
               most=0)
    for (kpad, codes), items in engine.trace_groups(
            engine.last_survivors).items():
        rec["groups"].append(f"{kpad}/{'+'.join(codes) or 'ACGT'}:"
                             f"{len(items)}")
        profs = [engine.db.profile(gi) for _, gi, *_ in items]
        chunks = vtr.chunk_reads(profs, [encoded[si] for si, *_ in items],
                                 codes)
        lo = 0
        while True:
            t0 = time.perf_counter()
            try:
                chunk_p, eidx, lens = next(chunks)
            except StopIteration:
                break
            H = len(lens)
            t1 = time.perf_counter()
            pk = vtr.pack_chunk(chunk_p, eidx, lens, kpad, codes,
                                p.multi_hits, p.hmmer3_compat, dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out = []
            k_ms = timed_ms(lambda: out.append(vtr.launch_trace(pk)))
            rec["kernel_ms"] += k_ms
            t3 = time.perf_counter()
            ys = out[0].host()
            t4 = time.perf_counter()
            K = pk.fmT.shape[2]
            paths = [vtr.walk({k: v[:, h] for k, v in ys.items()},
                              int(lens[h]), K) for h in range(H)]
            t5 = time.perf_counter()
            matches = [
                codec.render_match(codec.match_steps(
                    prof, seqs[si].data, path))
                for (si, *_), prof, path in zip(items[lo:lo + H],
                                                profs[lo:lo + H], paths)
            ]
            t6 = time.perf_counter()
            block = build_profile_block(chunk_p, kpad=kpad, codes=codes)
            t7 = time.perf_counter()
            _, pys = vtr.trace_dp(block, eidx, lens, p.multi_hits,
                                  p.hmmer3_compat, dev)
            t8 = time.perf_counter()
            for key, dt in zip(("build", "pack", "d2h", "walk", "codec",
                                "host_block", "plain"),
                               (t1 - t0, t2 - t1, t4 - t3, t5 - t4,
                                t6 - t5, t7 - t6, t8 - t7)):
                t[key] += dt
            cw = f"{what} pass 2, group (K={kpad}, {codes or 'ACGT'})"
            n, bad, top = table_ulps(pk, block)
            if top > 1:
                raise SystemExit(f"{cw}: card tables {top} ulp from the "
                                 "host block's")
            rec["entries"] += n
            rec["apart"] += bad
            rec["most"] = max(rec["most"], top)
            rec["worst"] = max(rec["worst"], compare_ys(ys, pys, lens, cw))
            compare_paths(ys, pys, lens, K, cw)
            for (si, gi, *_), path, match in zip(items[lo:lo + H], paths,
                                                 matches):
                hit = by_pair[(si, gi)]
                if hit.path != path or hit.match != match:
                    raise SystemExit(f"{cw}: hit ({si}, {gi}) differs from "
                                     "the replayed chunk")
            nb, nc = trace_work(block, eidx, lens)
            rec["nbytes"] += nb
            rec["cells"] += nc
            rec["chunks"] += 1
            rec["hits"] += H
            rec["block_bytes"] = max(rec["block_bytes"], block.fm.nbytes)
            lo += H
            del out, pk
    rec["scan_parts"] = trace_scan_parts(engine, seqs)
    rec.update(t)
    rec["plain_ms"] = 1e3 * t["plain"]
    b_ms, b_by = bound(rec["nbytes"], rec["cells"], "trace", clock)
    kernel_path = (t["build"] + t["pack"] + 1e-3 * rec["kernel_ms"]
                   + t["d2h"] + t["walk"] + t["codec"])
    plain_path = (t["build"] + t["host_block"] + t["plain"] + t["walk"]
                  + t["codec"])
    print(f"{what} pass 2 replay: {rec['hits']} hits in {rec['chunks']} "
          f"chunks (width/class:hits {' '.join(rec['groups'])}; largest "
          f"host match table {rec['block_bytes']} B); card tables "
          f"{rec['apart']} of {rec['entries']} entries apart from the host "
          f"blocks', at most {rec['most']} ulp; every array equal "
          f"trace_dp's on the host blocks, on the card (VT max|d| "
          f"{rec['worst']:.3g}), paths and match strings equal the scan's; "
          f"reads {t['build']:.4f} s, card-route pack (host rows, uploads, "
          f"tables on the card) {t['pack']:.4f} s, kernel "
          f"{rec['kernel_ms']:.3f} ms (CUDA events), D2H {t['d2h']:.4f} s, "
          f"walk {t['walk']:.4f} s, codec {t['codec']:.4f} s: "
          f"{kernel_path:.4f} s (host clock), the kernel "
          f"{100 * 1e-3 * rec['kernel_ms'] / kernel_path:.2f}% of it, the "
          f"pack {100 * t['pack'] / kernel_path:.1f}%, the codec "
          f"{100 * t['codec'] / kernel_path:.1f}%, the walk "
          f"{100 * t['walk'] / kernel_path:.2f}%; the host blocks of the "
          f"CPU route {t['host_block']:.4f} s, and with trace_dp on the "
          f"card on them ({t['plain']:.4f} s): {plain_path:.4f} s; kernel "
          f"bound {b_ms:.4f} ms by {b_by} ({rec['nbytes']} B, "
          f"{rec['cells']} node-positions), kernel at "
          f"{100 * b_ms / max(rec['kernel_ms'], 1e-9):.2f}% of it")
    print(f"{what} pass 2 as the scan runs it: "
          f"{parts_line(rec['scan_parts'])}")
    return rec


def main_path_inputs(workdir: str):
    """(db, .hmm, .dtp, reads, planted, fasta) of phase 3: the
    Pfam-shaped DB of NPROF profiles, pressed by the CLI, and the mixed
    reads (``mixed_reads``) written to a FASTA."""
    from deciphon_tpu_torch.db.format import TensorDB
    from deciphon_tpu_torch.models.h3writer import random_h3, write_h3

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
    return db, hmm, dtp, reads, planted, fasta


def warm_worker(tree: str, dtp: str, fasta: str) -> int:
    """One turn of ``phase_warm_compare`` (--warm-worker): the engine of
    the checkout ``tree`` on the card, per algorithm a cold scan of the
    FASTA's reads (builds, tables) and 3 warm ones; prints one JSON line
    of each warm scan's seconds and pass 2 (host clock, the card synced
    around each scan) and, where ``tree`` has trace_scan, the parts of
    one more pass 2 (``trace_scan_parts``)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import deciphon_tpu_torch
    from deciphon_tpu_torch.db.format import TensorDB
    from deciphon_tpu_torch.ops import viterbi_trace as vtr
    from deciphon_tpu_torch.ops.scan_engine import (
        ScanEngine, ScanParams, SeqRecord,
    )

    if not deciphon_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(
            f"warm worker: imported {deciphon_tpu_torch.__file__}")
    seqs = [SeqRecord(i + 1, n, r)
            for i, (n, r) in enumerate(read_records(fasta))]
    db = TensorDB.load(dtp)
    out = {}
    for algo in ALGO.values():
        engine = ScanEngine(db, ScanParams(algo=algo),
                            device=torch.device("cuda", 0))
        engine.scan(seqs)
        rec = dict(scan_s=[], pass2_s=[])
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.scan(seqs)
            torch.cuda.synchronize()
            rec["scan_s"].append(time.perf_counter() - t0)
            rec["pass2_s"].append(engine.last_timings["pass2"])
        rec["survivors"] = len(engine.last_survivors)
        if hasattr(vtr, "trace_scan"):
            rec["parts"] = trace_scan_parts(engine, seqs)
        out[algo] = rec
        del engine
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def phase_warm_compare(workdir: str, parent: str) -> None:
    """Warm scans of phase 3's DB and reads by this checkout's engine and
    by ``parent``'s, each turn a worker process (``warm_worker``), in
    turns parent / this / this / parent: per turn and algorithm the warm
    scans' and their pass 2's seconds (host clock), and this checkout's
    pass 2 split into trace_scan's parts."""
    _, _, dtp, _, _, fasta = main_path_inputs(workdir)
    here = os.path.dirname(os.path.abspath(__file__))
    for name, tree in (("parent", parent), ("this", here), ("this", here),
                       ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--warm-worker",
             tree, dtp, fasta], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"warm worker {name} failed "
                             f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        for algo, r in rec.items():
            print(f"warm compare {name} {algo}: {r['survivors']} survivors; "
                  f"warm scans {', '.join(f'{x:.4f}' for x in r['scan_s'])}"
                  f" s, their pass 2 "
                  f"{', '.join(f'{x:.4f}' for x in r['pass2_s'])} s (host "
                  f"clock)" + (f"; pass 2 once more: {parts_line(r['parts'])}"
                               if "parts" in r else ""))


def read_records(fasta: str) -> list[tuple[str, str]]:
    """(name, read) of each record of a FASTA written by
    ``main_path_inputs`` (one line a read)."""
    lines = open(fasta).read().split()
    return [(n[1:], r) for n, r in zip(lines[::2], lines[1::2])]


def cold_worker(dtp: str, fasta: str, algo: str, warm: str,
                device: str) -> int:
    """One cold start (--cold-worker), in a fresh process: host-clock
    seconds of importing torch and the package, TensorDB.load, on a card
    the CUDA context and the kernel library (built by the parent, so
    loaded), with ``warm == "1"`` the warmup split into the tables
    (``Tables.prepare``) and its launches (``warmup``, which then finds
    them built), and two scans of the FASTA's reads, the card synced after
    each step.  On a card the engine's pass-1 entry point
    (``dcp_viterbi_max`` or ``dcp_viterbi_lse``) is timed on the host
    clock at every call: a kernel instantiation's first launch loads it
    there (CUDA's lazy module loading), so these are the seconds a scan
    pays for instantiations that nothing launched before.  Prints one
    JSON line: the seconds, the warmup's launches, each call's seconds
    in the warmup and in each scan, each scan's ``last_timings`` and
    the run's launches."""
    t, t0 = {}, time.perf_counter()
    import torch

    t["import torch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from deciphon_tpu_torch.db.format import TensorDB
    from deciphon_tpu_torch.ops import _build, tables
    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops import viterbi_trace as vtr
    from deciphon_tpu_torch.ops.scan_engine import (
        ScanEngine, ScanParams, SeqRecord,
    )

    t["import package"] = time.perf_counter() - t0

    dev = torch.device(device)
    card = dev.type == "cuda"

    def step(name, fn):  # every step before it has synced
        t0 = time.perf_counter()
        out = fn()
        if card:
            torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        return out

    t0 = time.perf_counter()
    db = TensorDB.load(dtp)  # host only: no sync, which would start CUDA
    t["TensorDB.load"] = time.perf_counter() - t0
    if card:
        step("CUDA context", lambda: torch.zeros(1, device=dev))
        step("kernel library", _build.library)
    seqs = [SeqRecord(i + 1, n, r)
            for i, (n, r) in enumerate(read_records(fasta))]
    params = ScanParams(algo=algo)
    engine = ScanEngine(db, params, device=dev)
    calls = []  # host seconds of each call of the pass-1 entry point
    if card:
        lib = _build.library()
        entry = ("dcp_viterbi_max" if params.semiring == "max"
                 else "dcp_viterbi_lse")
        real = getattr(lib, entry)

        def timed(*a):
            t0 = time.perf_counter()
            rc = real(*a)
            calls.append(time.perf_counter() - t0)
            return rc

        setattr(lib, entry, timed)
    out = dict(blocks=len(engine.blocks), build_s=_build.BUILD_SECONDS,
               launch_s={})
    if warm == "1":
        step("warmup tables", engine.tables.prepare)
        step("warmup launches", lambda: engine.warmup(
            len(seqs), max(len(q.data) for q in seqs)))
        out["warm_launches"] = dict(vc.LAUNCHES)
        out["launch_s"]["warmup"] = calls[:]
    phases = []
    for name in ("first", "second"):
        del calls[:]
        hits = step(f"{name} scan", lambda: engine.scan(seqs))
        phases.append(engine.last_timings)
        out["launch_s"][name] = calls[:]
    out.update(t=t, phases=phases, hits=len(hits),
               launches=dict(vc.LAUNCHES),
               trace_launches=vtr.LAUNCHES[TRACE_NAME],
               table_launches=tables.LAUNCHES[TABLES_NAME])
    print(json.dumps(out))
    return 0


def cold_daemon(dtp: str, fasta: str, workdir: str, device: str) -> int:
    """A fresh daemon (--cold-daemon): Server(device=device) in this new
    process, against a localhost FakeScheduler holding the .dtp pressed
    by another process (so no press prewarm ran) and one scan job of the
    FASTA's reads.  Prints one JSON line: the job's seconds, the spool's
    (from the first read asked of the scheduler to the last), each
    warmup's thread and start and end (seconds from the job's start),
    the job's state and product rows, and its launches."""
    import threading

    import torch

    from deciphon_tpu_torch.ops import scan_engine as pse
    from deciphon_tpu_torch.ops import tables
    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops import viterbi_trace as vtr
    from deciphon_tpu_torch.server.daemon import Server
    from deciphon_tpu_torch.server.fake_sched import FakeScheduler
    from deciphon_tpu_torch.utils.config import ServerConfig

    fake = FakeScheduler(spool_dir=os.path.join(workdir, "cold_sched"))
    url = fake.serve()
    try:
        with open(dtp, "rb") as fp:
            db = fake.add_db(os.path.basename(dtp), fp.read())
        scan = fake.add_scan(db.id, read_records(fasta))
        server = Server(ServerConfig(
            cache_dir=os.path.join(workdir, "cold_daemon"), api_url=url,
            single_run=True), device=device)
        t0, spool, warms = time.perf_counter(), [], []
        real_iter = server.api.iter_scan_seqs

        def iter_scan_seqs(scan_id):
            spool.append(time.perf_counter() - t0)
            yield from real_iter(scan_id)
            spool.append(time.perf_counter() - t0)

        real_warmup = pse.ScanEngine.warmup

        def warmup(self, nseqs, max_len):
            start = time.perf_counter() - t0
            real_warmup(self, nseqs, max_len)
            warms.append((threading.current_thread().name, nseqs, max_len,
                          start, time.perf_counter() - t0))

        server.api.iter_scan_seqs = iter_scan_seqs
        pse.ScanEngine.warmup = warmup
        ran = server.run_one()
        if server.device.type == "cuda":
            torch.cuda.synchronize()
        job = fake.jobs[scan.job_id]
        print(json.dumps(dict(
            ran=ran, job_s=time.perf_counter() - t0, state=job.state,
            error=job.error, spool=spool, warmups=warms,
            rows=len(fake.products[-1].splitlines()) - 1
            if fake.products else 0,
            launches=dict(vc.LAUNCHES),
            trace_launches=vtr.LAUNCHES[TRACE_NAME],
            table_launches=tables.LAUNCHES[TABLES_NAME])))
    finally:
        fake.shutdown()
    return 0


def run_json(*args) -> dict:
    """This script in a fresh process with ``args``: its last stdout
    line, a JSON object, with the process's wall seconds (host clock,
    interpreter start-up included) under "wall_s"."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{args[0]} failed ({proc.returncode}):\n"
                         f"{proc.stderr[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def phase_cold_start(ctx, workdir: str, dev) -> dict:
    """Phase 3b: the cold start, on phase 3's DB and reads.  Per
    algorithm a fresh process with the warmup and one without
    (``cold_worker``), each step on the host clock; the warmup must
    launch the semiring's kernel once per block and no other, and the
    pass-1 entry point's calls in the first scan after it must take no
    more than in the second plus LOAD_MARGIN_S (the run without the
    warmup prints the same sums: its first scan loads every
    instantiation).  Then
    the CLI without its warmup (``cli_nowarm``): its products must equal
    phase 3's warmed CLI's byte for byte.  Then a fresh daemon's scan job
    (``cold_daemon``): job and spool seconds, whether the warmup begun
    during the spool ended inside it, rows equal in number to phase 3's
    hits.  Each process must launch csrc/tables.cu once per extended
    block and scan (the warmup builds none).  Returns the launches of
    these runs, per semiring and under TRACE_NAME and TABLES_NAME."""
    launches = dict.fromkeys((*TOL, TRACE_NAME, TABLES_NAME), 0)
    for semiring in TOL:
        algo = ALGO[semiring]
        for warm in ("1", "0"):
            rec = run_json("--cold-worker", ctx["dtp"], ctx["fasta"], algo,
                           warm, dev.type)
            for k, n in rec["launches"].items():
                launches[k] += n
            launches[TRACE_NAME] += rec["trace_launches"]
            launches[TABLES_NAME] += check_table_launches(
                rec["table_launches"], 2 * ctx["tables_per_scan"],
                f"cold start {algo}, warmup {warm} (two scans)")
            steps = ", ".join(f"{k} {v:.4f} s" for k, v in rec["t"].items())
            phases = "; ".join(
                f"{n} scan pass 1 {p['pass1']:.4f} s, gate {p['gate']:.4f} "
                f"s, pass 2 {p['pass2']:.4f} s"
                for n, p in zip(("first", "second"), rec["phases"]))
            how = "warmup" if warm == "1" else "no warmup"
            total = sum(rec["t"].values())
            print(f"cold start {algo}, {how} (fresh process, host clock, "
                  f"the card synced after each step): {steps}; steps "
                  f"{total:.4f} s of the process's {rec['wall_s']:.4f} s; "
                  f"{phases}; "
                  f"BUILD_SECONDS {rec['build_s']:.4f}; {rec['hits']} hits; "
                  f"launches {rec['launches']}")
            calls = rec["launch_s"]
            print(f"cold start {algo}, {how}: pass-1 entry point calls "
                  "(host clock): " + "; ".join(
                      f"{k} {len(v)} calls {sum(v) * 1e3:.4f} ms, slowest "
                      f"{max(v, default=0) * 1e3:.4f} ms"
                      for k, v in calls.items()))
            if warm == "0":
                continue
            got = rec["warm_launches"]
            other = sum(n for k, n in got.items() if k != semiring)
            if got[semiring] != rec["blocks"] or other:
                raise SystemExit(f"cold start {algo}: warmup launches {got},"
                                 f" want {rec['blocks']} {semiring} (one a "
                                 "block)")
            extra = sum(calls["first"]) - sum(calls["second"])
            if extra > LOAD_MARGIN_S:
                raise SystemExit(f"cold start {algo}: the first scan's "
                                 f"launch calls took {extra * 1e3:.4f} ms "
                                 "over the second's, more than "
                                 f"{LOAD_MARGIN_S * 1e3:.1f} ms: the warmup "
                                 "left instantiations to load")
            print(f"cold start {algo}: warmup {got[semiring]} "
                  f"{KERNEL_NAME[semiring]} launches = {rec['blocks']} "
                  f"blocks; the first scan's launch calls "
                  f"{extra * 1e3:+.4f} ms against the second's (limit "
                  f"{LOAD_MARGIN_S * 1e3:.1f} ms)")

        tsv = os.path.join(workdir, f"prods_{algo}.tsv")
        cold_tsv = os.path.join(workdir, f"prods_{algo}_nowarm.tsv")
        cli("scan", ctx["dtp"], ctx["fasta"], "-o", cold_tsv, "--device",
            dev.type, *(["--forward"] if algo == "forward" else []),
            warm=False)
        with open(tsv, "rb") as a, open(cold_tsv, "rb") as b:
            if a.read() != b.read():
                raise SystemExit(f"cli scan {algo}: products with and "
                                 "without the warmup differ")
        print(f"cli scan {algo}: products with and without the warmup equal "
              "byte for byte")

    rec = run_json("--cold-daemon", ctx["dtp"], ctx["fasta"], workdir,
                   dev.type)
    if not rec["ran"] or rec["state"] != "done":
        raise SystemExit(f"cold daemon: job {rec['state']}: {rec['error']}")
    if rec["rows"] != len(ctx["hits"]) or len(rec["warmups"]) != 2:
        raise SystemExit(f"cold daemon: {rec['rows']} rows (want "
                         f"{len(ctx['hits'])}), warmups {rec['warmups']}")
    for k, n in rec["launches"].items():
        launches[k] += n
    launches[TRACE_NAME] += rec["trace_launches"]
    launches[TABLES_NAME] += check_table_launches(
        rec["table_launches"], ctx["tables_per_scan"], "cold daemon")
    (t1, n1, l1, s1, e1), (t2, n2, l2, s2, e2) = rec["warmups"]
    s0, s_end = rec["spool"]
    print(f"cold daemon (fresh process of {rec['wall_s']:.4f} s, host "
          f"clock): scan job {rec['job_s']:.4f} s, {rec['rows']} rows; spool "
          f"{s_end - s0:.4f}"
          f" s ({s0:.4f}-{s_end:.4f} s into the job); warmup on {t1} "
          f"({n1} reads, {l1} nt) {s1:.4f}-{e1:.4f} s, "
          f"{'inside' if e1 <= s_end else 'not inside'} the spool; top-up "
          f"on {t2} ({n2} reads, {l2} nt) {s2:.4f}-{e2:.4f} s; launches "
          f"{rec['launches']}, {rec['trace_launches']} {TRACE_NAME}")
    return launches


def phase_main_path(dev, workdir: str, clock: float):
    """(per semiring: launches, max_abs_err, ms, plain_ms, bound_ms,
    bound_by of the main path; the context phases 4 and 5 compare
    with)."""
    import torch

    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops.scan_engine import (
        ScanEngine, ScanParams, SeqRecord,
    )
    from deciphon_tpu_torch.utils import trace

    db, hmm, dtp, reads, planted, fasta = main_path_inputs(workdir)
    seqs = [SeqRecord(i + 1, f"r{i + 1}", r) for i, r in enumerate(reads)]
    nodes = int(db.core_sizes.sum())
    cells = 3 * sum(map(len, reads)) * nodes
    out = {}
    ctx = dict(db=db, seqs=seqs, planted=planted, hmm=hmm, dtp=dtp,
               fasta=fasta, cells=cells, scores={}, warm={})
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
        engine.tables.prepare()
        torch.cuda.synchronize()
        print(f"engine: {len(engine.blocks)} blocks, base-4 tables built in "
              f"{time.perf_counter() - t0:.2f} s")
        encoded, classes = engine.encode(seqs)
        reset_launches()
        with counting_trace_dp() as plain_calls, trace.recording():
            hits = engine.scan(seqs)
        launches = dict(vc.LAUNCHES)
        tb = check_trace_launches(engine, plain_calls[0],
                                  f"main path {algo}")
        ext_classes = sum(1 for codes in classes if codes)
        ctx["tables_per_scan"] = ext_slices(engine, classes)
        ctx["ext_classes"] = ext_classes
        ctx["class_codes"] = list(classes)
        tl = check_table_launches(table_launches(), ctx["tables_per_scan"],
                                  f"main path {algo}")
        ctx["table_launches"] = ctx.get("table_launches", 0) + tl
        want = len(engine.blocks) * (len(classes) - ext_classes) + tl
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
              f"classes; {tl} {TABLES_NAME} launches = "
              f"{len(engine.blocks)} blocks x {ext_classes} classes with "
              f"codes, one slice each; pass 2: {tb} {TRACE_NAME} launches "
              f"for {len(engine.last_survivors)} survivors, no trace_dp "
              "call")
        ctx["table_launches"] += check_sliced_scan(
            engine, seqs, classes, hits, semiring, f"main path {algo}")
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
        replay = pass2_replay(engine, seqs, hits, dev, clock,
                              f"main path {algo}")
        replay["launches"] = tb
        replay["pass2_s"] = tm["pass2"]
        ctx.setdefault("trace", {})[semiring] = replay
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


def ulps(a, b):
    """Distances in f32 units in the last place between two f32 tensors
    of one shape (on the float line ordered as integers), int64."""
    import torch

    def key(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (key(a) - key(b)).abs()


def ulps_apart(a, b):
    """Largest of ``ulps``: 0 for empty tensors."""
    return int(ulps(a, b).max()) if a.numel() else 0


def table_ulps(pk, block) -> tuple[int, int, int]:
    """(entries, entries more than 0 ulp apart, the most ulps apart) of
    the pass-2 tables of ``pk`` (viterbi_trace.pack_chunk, the card
    route) against the host block ``block`` of build_profile_block: fmT
    against fm transposed, fin against fi and fn stacked."""
    import torch

    host = {"fmT": block.fm.transpose(0, 2, 1),
            "fin": np.stack([block.fi, block.fn], 1)}
    n = bad = top = 0
    for name in ("fmT", "fin"):
        got = getattr(pk, name)
        d = ulps(got, torch.from_numpy(np.ascontiguousarray(
            host[name])).to(got.device))
        n, bad = n + d.numel(), bad + int((d > 0).sum())
        top = max(top, int(d.max()))
    return n, bad, top


def phase_ext_tables(db, dev) -> dict:
    """Phase 3c: the extended tables of every block of ``db`` on the
    card, for each class of EXT_CODES, built twice from a store's
    resident inputs: by csrc/tables.cu (``CudaBlock.extended``: the f64
    pattern-marginal product, then one launch) and by its plain version
    ``block_tables_plain`` (synth_fragment_tables, node and insert/null
    rows apart).  fm and fin must agree within TABLES_ULPS units in the
    last place; prints max |d|, ulps, launches, card time of each
    (CUDA events, min of 3), bytes written and the kernel's share of
    their floor at 3.35 TB/s.  Returns the kernel table's row, whose
    launches ``main`` takes from the scans of phases 3-3b."""
    import torch

    from deciphon_tpu_torch.ops import tables
    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops.scan_engine import Tables
    from deciphon_tpu_torch.utils import trace

    print("--- extended tables: csrc/tables.cu vs synth_fragment_tables ---")
    store = Tables(db, dev)
    store.prepare()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with trace.recording(), trace.root("ext_inputs") as rec:
        store._ext_inputs()
        store._ext_inputs()
    torch.cuda.synchronize()
    inputs = [blk.ext[0] for blk in store.blocks]
    in_bytes = sum(4 * (e.emis.numel() + e.qp.numel()) for e in inputs)
    if rec.counts.get("ext_inputs_built") != 1:
        raise SystemExit(f"ext inputs built {rec.counts}: want 1")
    print(f"resident inputs: {len(inputs)} blocks, {in_bytes} B, built "
          f"once in {time.perf_counter() - t0:.2f} s (host clock)")
    bases = [t.blk for blk in store.blocks for t in store.tiles(blk)]
    worst = {"ulps": 0, "abs": 0.0}
    k_total = p_total = 0.0
    written = 0
    for codes in EXT_CODES:
        n0 = table_launches()
        kern = [vc.CudaBlock.extended(e, b, codes)
                for e, b in zip(inputs, bases)]
        launched = table_launches() - n0
        if launched != len(inputs):
            raise SystemExit(f"{codes}: {launched} tables launches for "
                             f"{len(inputs)} blocks")
        d_abs, d_ulp = 0.0, 0
        nbytes = 0
        for e, blk in zip(inputs, kern):
            fm, fin = tables.block_tables_plain(e.emis, e.qp, e.eps, codes,
                                                e.B, e.kpad)
            for got, want in ((blk.fm, fm), (blk.fin, fin)):
                if got.shape != want.shape:
                    raise SystemExit(f"{codes}: shape {tuple(got.shape)} "
                                     f"vs {tuple(want.shape)}")
                d_abs = max(d_abs, float((got - want).abs().max()))
                d_ulp = max(d_ulp, ulps_apart(got, want))
                nbytes += 4 * got.numel()
            del fm, fin
        del kern
        torch.cuda.empty_cache()

        def run_kernel():
            for e, b in zip(inputs, bases):
                vc.CudaBlock.extended(e, b, codes)

        def run_plain():
            for e in inputs:
                tables.block_tables_plain(e.emis, e.qp, e.eps, codes, e.B,
                                          e.kpad)

        mq = [tables._ext_inputs(e.emis, e.qp, codes, e.eps)
              for e in inputs]
        l_ms = timed_ms(lambda: [tables.launch_tables(
            me, qe, e.eps, codes, e.B, e.kpad)
            for (me, qe), e in zip(mq, inputs)], reps=3)
        del mq
        k_ms = timed_ms(run_kernel, reps=3)
        p_ms = timed_ms(run_plain, reps=3)
        floor_ms = 1e3 * nbytes / PEAK_BYTES
        ntab = tables.term_rows(codes)[0].shape[0] - 1
        print(f"class {codes} (ntab {ntab}): max|d| {d_abs:.3g}, "
              f"{d_ulp} ulp; {launched} launches a build; kernel "
              f"{l_ms:.3f} ms, {k_ms:.3f} ms with the f64 products, vs "
              f"plain {p_ms:.3f} ms; {nbytes} B written, floor "
              f"{floor_ms:.3f} ms, kernel at {100 * floor_ms / l_ms:.1f}% "
              f"of it")
        if d_ulp > TABLES_ULPS:
            raise SystemExit(f"{codes}: kernel tables {d_ulp} ulp off "
                             f"the plain version (max|d| {d_abs})")
        worst["ulps"] = max(worst["ulps"], d_ulp)
        worst["abs"] = max(worst["abs"], d_abs)
        k_total += l_ms
        p_total += p_ms
        written += nbytes
    # seven codes (base 11): Me outgrows shared memory and the kernel
    # reads it from device memory; two of the narrowest profiles
    small = np.argsort(db.core_sizes, kind="stable")[:2]
    profs = [db.profile(int(i)) for i in small]
    e = vc.CompactInputs.from_profiles(
        profs, max(p.core_size for p in profs), dev)
    got = e.tables(TABLES_WIDE)
    want = tables.block_tables_plain(e.emis, e.qp, e.eps, TABLES_WIDE,
                                     e.B, e.kpad)
    d_ulp = max(ulps_apart(g, w) for g, w in zip(got, want))
    d_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"class {TABLES_WIDE} (ntab {got[0].shape[1]}, {e.B} profiles, "
          f"K {e.kpad}, Me from device memory): max|d| {d_abs:.3g}, "
          f"{d_ulp} ulp")
    if d_ulp > TABLES_ULPS:
        raise SystemExit(f"{TABLES_WIDE}: kernel tables {d_ulp} ulp off")
    worst["ulps"] = max(worst["ulps"], d_ulp)
    worst["abs"] = max(worst["abs"], d_abs)
    del store, bases, inputs, got, want
    torch.cuda.empty_cache()
    return {
        "name": "tables", "route": "cuda", "source": TABLES_SOURCE,
        "replaces": TABLES_REPLACES,
        "max_abs_err": worst["abs"], "max_ulps": worst["ulps"],
        "ms": k_total, "plain_ms": p_total,
        "bound_ms": 1e3 * written / PEAK_BYTES, "bound_by": "bytes",
        "library_ms": None,
    }


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
    """Per semiring: launches of the sharded scans; under TRACE_NAME and
    TABLES_NAME the traceback and table launches of both."""
    import torch

    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine, ScanParams
    from deciphon_tpu_torch.utils import trace

    db, seqs = ctx["db"], ctx["seqs"]
    mesh, kind = scan_mesh()
    print(f"mesh: {mesh.seqs} read shards x {mesh.profiles} profile shards "
          f"({kind})")
    out = {}
    for semiring in TOL:
        algo = ALGO[semiring]
        engine = ScanEngine(db, ScanParams(algo=algo), mesh=mesh)
        t0 = time.perf_counter()
        engine.tables.prepare()
        torch.cuda.synchronize()
        ntiles = sum(len(b.tiles) for b in engine.blocks)
        print(f"sharded {algo}: {len(engine.blocks)} blocks, {ntiles} tiles, "
              f"base-4 tables built in {time.perf_counter() - t0:.2f} s")
        reset_launches()
        with counting_trace_dp() as plain_calls, trace.recording():
            hits = engine.scan(seqs)
        launches = dict(vc.LAUNCHES)
        tb = check_trace_launches(engine, plain_calls[0], f"sharded {algo}")
        # one synthesis per profile slice of a shard, copied down its
        # mesh column
        shards = sum(len({t.p for t in b.tiles}) for b in engine.blocks)
        tl = check_table_launches(table_launches(),
                                  ext_slices(engine, ctx["class_codes"]),
                                  f"sharded {algo}")
        want = ntiles * ctx["classes"]
        other = sum(n for s, n in launches.items() if s != semiring)
        if launches[semiring] != want or other:
            raise SystemExit(f"sharded launches {launches}: want {want} "
                             f"{semiring} (tiles x classes)")
        print(f"sharded scan: {want} {KERNEL_NAME[semiring]} launches = "
              f"{ntiles} tiles over {len(engine.blocks)} blocks x "
              f"{ctx['classes']} classes; {tl} {TABLES_NAME} launches = "
              f"{shards} profile shards x {ctx['ext_classes']} classes "
              f"with codes, one slice each; pass 2: {tb} {TRACE_NAME} "
              "launches")
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
        out[TRACE_NAME] = out.get(TRACE_NAME, 0) + tb
        out[TABLES_NAME] = out.get(TABLES_NAME, 0) + tl
        del engine
        torch.cuda.empty_cache()
    return out


def phase_daemon(ctx, workdir: str) -> dict:
    """Per semiring, and under TRACE_NAME and TABLES_NAME: launches of
    the daemon's scan jobs."""
    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.server.daemon import Server
    from deciphon_tpu_torch.server.fake_sched import FakeScheduler
    from deciphon_tpu_torch.utils.config import ServerConfig

    db, seqs, planted = ctx["db"], ctx["seqs"], ctx["planted"]
    fake = FakeScheduler(spool_dir=os.path.join(workdir, "sched"))
    url = fake.serve()
    launches = dict.fromkeys((*TOL, TRACE_NAME, TABLES_NAME), 0)
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
                with counting_trace_dp() as plain_calls:
                    job_s = run_job(scan.job_id, mode)
                for k, n in vc.LAUNCHES.items():
                    launches[k] += n
                tb = trace_launches()
                launches[TRACE_NAME] += tb
                # one scan (or best_hits) call: the reads fit one batch
                launches[TABLES_NAME] += check_table_launches(
                    table_launches(), ctx["tables_per_scan"],
                    f"daemon {mode}")
            finally:
                os.environ.pop("DCP_BEST_HIT", None)
            if vc.LAUNCHES["max"] == 0:
                raise SystemExit(f"daemon {mode}: no kernel launch")
            # a scan job traces its survivors on the kernel; a best-hit
            # job has no pass 2
            waits = trace_waits()
            if ((tb == 0) == (mode == "scan") or plain_calls[0]
                    or waits != (mode == "scan")):
                raise SystemExit(f"daemon {mode}: {tb} {TRACE_NAME} "
                                 f"launches, {waits} host waits, "
                                 f"{plain_calls[0]} trace_dp calls")
            # the scheduler numbers this scan's reads in input order
            index = {q.id: i for i, q in enumerate(fake.seqs[scan.id])}
            rows_of[mode] = [
                (index[int(r[1])], r[2], float(r[4]), float(r[5]), r[8])
                for r in (ln.split("\t")
                          for ln in fake.products[-1].splitlines()[1:])
            ]
            print(f"daemon {mode}: {job_s:.2f} s (host clock), "
                  f"{len(rows_of[mode])} rows, {vc.LAUNCHES['max']} "
                  f"{KERNEL_NAME['max']} launches, {tb} {TRACE_NAME} "
                  "launches")
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


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_distributed(ctx, workdir: str, dev) -> int:
    """Viterbi launches of the workers' DB step, over both ranks."""
    import torch

    alt, null = ctx["scores"]["max"]
    # the ACGT reads are phase 3's first NREADS, its scores in read order
    np.savez(os.path.join(workdir, "dist_ref.npz"), alt=alt[:NREADS],
             null=null[:NREADS])
    torch.cuda.empty_cache()
    port = free_port()
    procs = []
    try:
        for rank in range(NPROCS):
            env = dict(os.environ, DCP_COORDINATOR=f"127.0.0.1:{port}",
                       DCP_NUM_PROCS=str(NPROCS), DCP_PROC_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 workdir, dev.type],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            ))
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("dist-worker ")]
        if p.returncode != 0 or not lines:
            raise SystemExit(f"distributed rank {rank} failed "
                             f"({p.returncode}):\n{out}\n{err}")
        rep = json.loads(lines[-1].split(" ", 1)[1])
        print(f"distributed rank {rep['rank']} on {rep['device']}: "
              f"worker_parity_check {rep['parity_s']:.3f} s, "
              f"{rep['parity_launches']} viterbi_max launches; DB step "
              f"{rep['tiles']} tiles, {rep['launches']} viterbi_max "
              f"launches, {rep['cells']} cells x (alt, null) equal phase "
              f"3's bit for bit, {rep['db_s']:.3f} s (host clock, tables "
              "included)")
        reports.append(rep)
    cells = sum(r["cells"] for r in reports)
    if cells != NREADS * NPROF:
        raise SystemExit(f"distributed ranks covered {cells} cells, want "
                         f"{NREADS * NPROF}")
    return sum(r["launches"] for r in reports)


def dist_worker(workdir: str, device: str) -> int:
    """One rank of phase 6 (run by phase_distributed)."""
    import torch
    import torch.distributed as dist

    from deciphon_tpu_torch.db.format import TensorDB
    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine, Tables
    from deciphon_tpu_torch.parallel import distributed as pd
    from deciphon_tpu_torch.utils.fasta import read_fasta

    pd.initialize()
    try:
        rank = dist.get_rank()
        reset_launches()
        parity_s, _ = pd.worker_parity_check(device=device)
        parity_launches = vc.LAUNCHES["max"]
        db = TensorDB.load(os.path.join(workdir, "pfam_shaped.dtp"))
        reads = [r for _, r in read_fasta(os.path.join(workdir, "reads.fa"))]
        ref = np.load(os.path.join(workdir, "dist_ref.npz"))
        order, eidx, slen = ScanEngine.host_batch(
            [encode(r, ()) for r in reads[:NREADS]])
        mesh = pd.global_scan_mesh(profile_axis=NPROCS, device=device)
        # the engine's blocks (widths and members); no table is built here
        blocks = Tables(db, device=mesh.devices[rank]).blocks
        reset_launches()
        t0 = time.perf_counter()
        pieces, ntiles = [], 0
        for blk in blocks:
            profiles = [db.profile(int(i)) for i in blk.chunk]
            tiles = pd.make_global_block(mesh, profiles, kpad=blk.kpad)
            ntiles += len(tiles)
            for rows, cols, alt, null in pd.global_viterbi_scores(
                mesh, profiles, eidx, slen, dev_block=tiles,
            ):
                pieces.append((order[rows], blk.chunk[cols], alt, null))
            del tiles
        if device == "cuda":
            torch.cuda.synchronize()
        db_s = time.perf_counter() - t0
        launches = vc.LAUNCHES["max"]
        if launches == 0 and device == "cuda":
            raise SystemExit(f"rank {rank}: no viterbi_max launch")
        cells = 0
        for rows, cols, alt, null in pieces:
            cell = np.ix_(rows, cols)
            for name, got in (("alt", alt), ("null", null)):
                want = ref[name][cell]
                got = got.cpu().numpy()
                if not np.array_equal(got, want):
                    d = float(np.abs(got - want).max())
                    raise SystemExit(f"rank {rank}: {name} differs from "
                                     f"phase 3's cells, max|d| {d}")
            cells += len(rows) * len(cols)
        dist.barrier()
        print("dist-worker " + json.dumps(dict(
            rank=rank, device=str(mesh.devices[rank]), parity_s=parity_s,
            parity_launches=parity_launches, tiles=ntiles,
            launches=launches, cells=cells, db_s=db_s)), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def phase_standard_dcp_parity(dev, workdir: str) -> None:
    """A standard scan through the CLI on the card against the CPU plain
    path, `info` on a reference .dcp and `parity` on a .hmm."""
    import msgpack

    from deciphon_tpu_torch.db import dcp
    from deciphon_tpu_torch.db.standard_db import write_standard_db
    from deciphon_tpu_torch.models.h3writer import random_h3, write_h3
    from deciphon_tpu_torch.models.standard import sample_standard
    from deciphon_tpu_torch.ops.viterbi_standard import scan_standard

    rng = np.random.default_rng(5)
    profiles = [sample_standard(s + 1, int(rng.integers(*STD_STATES)))
                for s in range(STD_PROFILES)]
    # two profiles that favour A and C runs, and reads holding them
    for j, sym in ((3, 0), (17, 1)):
        e = np.full(4, 0.01)
        e[sym] = 0.97
        profiles[j].alt_emis[:] = np.log(e)[None, :]
    reads = ["".join(rng.choice(list("ACGT"), int(n)))
             for n in rng.integers(20, 400, STD_READS - 2)]
    reads += ["A" * 60, "C" * 45]
    db = os.path.join(workdir, "standard.dtp")
    fasta = os.path.join(workdir, "standard.fa")
    tsv = os.path.join(workdir, "standard.tsv")
    write_standard_db(db, profiles)
    with open(fasta, "w") as fp:
        fp.writelines(f">s{i + 1}\n{r}\n" for i, r in enumerate(reads))
    cli("scan", db, fasta, "-o", tsv, "--device", dev.type)
    rows = [ln.split("\t") for ln in open(tsv).read().splitlines()[1:]]
    want = scan_standard(profiles, reads, device="cpu")
    if [(int(r[1]), r[2]) for r in rows] != [
        (q + 1, profiles[b].accession) for q, b, *_ in want
    ] or not rows:
        raise SystemExit(f"standard scan rows differ from the CPU plain "
                         f"path: {len(rows)} vs {len(want)}")
    worst = 0.0
    for r, (_, _, alt, null, _) in zip(rows, want):
        d = max(abs(float(r[4]) - alt), abs(float(r[5]) - null))
        if not d <= 1e-5 or "standard" not in r:
            raise SystemExit(f"standard scan row {r} vs {alt}, {null}")
        worst = max(worst, d)
    print(f"standard scan: {len(rows)} rows of {STD_READS} reads x "
          f"{STD_PROFILES} profiles equal the CPU plain path, logliks max|d| "
          f"{worst:.3g}")

    # a reference .dcp laid out as tests/test_dcp.py builds one
    prof = {"accession": "PF00001.1", "null": b"\x01" * 40,
            "alt": b"\x02" * 90, "core_size": 3, "consensus": "AAA",
            **{k: i + 1 for i, k in enumerate(dcp._SPECIALS)},
            "null_ndist": [b"\x03" * 8], "alt_insert_ndist": [b"\x03" * 8],
            "alt_match_ndist": [[b"\x03" * 8]] * 3}
    ref = os.path.join(workdir, "ref.dcp")
    with open(ref, "wb") as fp:
        fp.write(msgpack.packb({"header": {
            "magic_number": dcp.DCP_MAGIC, "profile_typeid": 2,
            "float_size": 4, "entry_dist": 2, "epsilon": 0.01,
            "abc": b"\x07" * 24, "amino": b"\x08" * 44,
            "profile_sizes": [511]}, "profiles": [prof]}, use_bin_type=True))
    out = cli("info", ref)
    if "reference .dcp" not in out or "dp decode:" not in out:
        raise SystemExit(f"info on a .dcp:\n{out}")
    hmm = os.path.join(workdir, "parity.hmm")
    with open(hmm, "w") as fp:
        write_h3(fp, [random_h3(7, 40, peak=0.9)])
    out = cli("parity", hmm, "-o", os.path.join(workdir, "parity.tsv"))
    if "PARITY OK" not in out:
        raise SystemExit(f"parity:\n{out}")


def phase_trace(ctx, dev, workdir: str) -> tuple[int, int, str]:
    """(viterbi_max launches, traceback launches, summary line) of one
    warm Viterbi scan of
    TRACE_READS of phase 3's ACGT reads under DCP_PROFILE_DIR: one
    planted read and the first non-planted ones, so pass 2 traces one
    survivor.  The Chrome trace must name the Viterbi and the traceback
    kernels; prints the
    kernel time by name and the device's idle share of the window from
    the first to the last device event."""
    import glob

    import torch

    from deciphon_tpu_torch.ops import viterbi_cuda as vc
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine

    db, seqs, planted = ctx["db"], ctx["seqs"], ctx["planted"]
    acgt = seqs[:NREADS]
    hit = min((s for s in planted if s <= NREADS),
              key=lambda s: len(seqs[s - 1].data))
    chosen = [seqs[hit - 1]] + [s for s in acgt if s.seq_id not in planted][
        :TRACE_READS - 1]
    engine = ScanEngine(db, device=dev)
    engine.tables.prepare()
    engine.scan(chosen)  # warm
    torch.cuda.synchronize()
    outdir = os.path.join(workdir, "profile")
    os.environ["DCP_PROFILE_DIR"] = outdir
    try:
        reset_launches()
        t0 = time.perf_counter()
        with counting_trace_dp() as plain_calls:
            hits = engine.scan(chosen)
        traced_s = time.perf_counter() - t0
        launches = vc.LAUNCHES["max"]
        tb = check_trace_launches(engine, plain_calls[0], "traced scan")
    finally:
        os.environ.pop("DCP_PROFILE_DIR")
    if (hit, planted[hit]) not in {(h.seq_id, h.profile_idx) for h in hits}:
        raise SystemExit("traced scan: the planted read missed")
    files = glob.glob(os.path.join(outdir, "scan", "*.json"))
    if len(files) != 1:
        raise SystemExit(f"traced scan: want one trace file, got {files}")
    with open(files[0]) as fp:
        events = json.load(fp)["traceEvents"]
    dev_events = [e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "dur" in e]
    by_name: dict[str, list[float]] = {}
    for e in dev_events:
        if e["cat"] == "kernel":
            by_name.setdefault(e["name"], []).append(float(e["dur"]))
    for kname in ("viterbi_kernel", "traceback_kernel"):
        if not any(kname in n for n in by_name):
            raise SystemExit(f"traced scan: no {kname} device event in "
                             f"{files[0]} ({len(dev_events)} device events: "
                             "is CUPTI missing?)")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev_events)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    window = end - spans[0][0]
    idle = 1.0 - busy / window
    print(f"traced scan: {len(chosen)} reads, {len(hits)} hits, "
          f"{launches} viterbi_max launches, {tb} {TRACE_NAME} launches, "
          f"{traced_s:.3f} s under the "
          f"profiler (host clock); trace {os.path.getsize(files[0])} B, "
          f"{len(events)} events, {len(dev_events)} on the device")
    kernel_total = sum(map(sum, by_name.values()))
    for name, durs in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
        print(f"  kernel time {sum(durs) / 1e3:.3f} ms x {len(durs)} "
              f"({100 * sum(durs) / kernel_total:.1f}%): {name[:100]}")
    vit, tbk = (sum(sum(d) for n, d in by_name.items() if k in n)
                for k in ("viterbi_kernel", "traceback_kernel"))
    summary = (f"trace: device window {window / 1e3:.3f} ms, busy "
               f"{busy / 1e3:.3f} ms, idle share {100 * idle:.1f}%; kernels "
               f"{kernel_total / 1e3:.3f} ms in {len(by_name)} names, "
               f"viterbi_kernel {vit / 1e3:.3f} ms, traceback_kernel "
               f"{tbk / 1e3:.3f} ms")
    print(summary)
    del engine
    torch.cuda.empty_cache()
    return launches, tb, summary


def main(argv: list[str]) -> int:
    if argv[:1] == ["--dist-worker"] and len(argv) == 3:
        return dist_worker(*argv[1:])  # one rank of phase 6
    if argv[:1] == ["--warm-worker"] and len(argv) == 4:
        return warm_worker(*argv[1:])  # one turn of the warm compare
    if argv[:1] == ["--cold-worker"] and len(argv) == 6:
        return cold_worker(*argv[1:])  # one run of phase 3b
    if argv[:1] == ["--cold-daemon"] and len(argv) == 5:
        return cold_daemon(*argv[1:])  # phase 3b's daemon
    if argv[:1] == ["--cli-nowarm"]:
        return cli_nowarm(argv[1:])  # phase 3b's CLI without its warmup
    import torch

    menu_only = argv == ["--menu-only"]
    sweep = argv[:1] == ["--trace-sweep"] and len(argv) <= 2
    if argv and not (menu_only or sweep):
        print("usage: chip_smoke.py [--menu-only | "
              "--trace-sweep [PARENT_TREE]]", file=sys.stderr)
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
    if sweep:  # phase 1, the pass-2 menu and the plans' sweep
        parent = argv[1] if len(argv) == 2 else None
        phase_trace_menu(dev, clock)
        phase_trace_sweep(dev, clock, parent)
        print(f"trace sweep done at {time.perf_counter() - t_start:.1f} s")
        if parent:
            workdir = os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "build", "warm_compare")
            os.makedirs(workdir, exist_ok=True)
            try:
                phase_warm_compare(workdir, parent)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            print(f"warm compare done at "
                  f"{time.perf_counter() - t_start:.1f} s")
        return 0
    menu_err = phase_kernel_menu(dev)
    print(f"menu done at {time.perf_counter() - t_start:.1f} s")
    menu_err[TRACE_NAME] = phase_trace_menu(dev, clock)
    print(f"trace menu done at {time.perf_counter() - t_start:.1f} s")
    # scratch for the synthetic DB and reads, inside the checkout
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    if menu_only:  # phases 1-2 and 3c on phase 3's DB, then stop
        try:
            row = phase_ext_tables(main_path_inputs(workdir)[0], dev)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"kernels": [row]}))
        return 0
    try:
        main_path, ctx = phase_main_path(dev, workdir, clock)
        print(f"main path done at {time.perf_counter() - t_start:.1f} s")
        tables_row = phase_ext_tables(ctx["db"], dev)
        print(f"extended tables done at "
              f"{time.perf_counter() - t_start:.1f} s")
        cold = phase_cold_start(ctx, workdir, dev)
        print(f"cold start done at {time.perf_counter() - t_start:.1f} s")
        sharded = phase_sharded(ctx)
        print(f"sharded done at {time.perf_counter() - t_start:.1f} s")
        daemon = phase_daemon(ctx, workdir)
        print(f"daemon done at {time.perf_counter() - t_start:.1f} s")
        t6 = time.perf_counter()
        distributed = phase_distributed(ctx, workdir, dev)
        print(f"distributed done at {time.perf_counter() - t_start:.1f} s")
        phase_standard_dcp_parity(dev, workdir)
        traced, traced_tb, trace_summary = phase_trace(ctx, dev, workdir)
        print(f"host entry points and trace done at "
              f"{time.perf_counter() - t_start:.1f} s (phases 6-7: "
              f"{time.perf_counter() - t6:.1f} s)")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "deciphon_tpu"))
    if bad:
        raise SystemExit(f"imported {bad}")
    kernels = []
    for semiring, rec in main_path.items():
        rec["max_abs_err"] = max(rec["max_abs_err"], menu_err[semiring])
        viterbi = semiring == "max"
        per_path = dict(zip(PATHS, (
            rec["launches"], sharded[semiring], daemon[semiring],
            distributed if viterbi else 0, traced if viterbi else 0,
            cold[semiring],
        )))
        kernels.append({
            "name": KERNEL_NAME[semiring], "route": "cuda",
            "source": KERNEL_SOURCE[semiring], "replaces": KERNEL_REPLACES,
            **rec,
            "paths": {k: n for k, n in per_path.items() if n},
        })
    # pass 2's kernel: the two phase-3 scans (Viterbi and forward) are
    # its main path; times and bound over their chunks' replays
    tr = ctx["trace"].values()
    t_bytes = sum(r["nbytes"] for r in tr)
    t_cells = sum(r["cells"] for r in tr)
    t_bound, t_by = bound(t_bytes, t_cells, "trace", clock)
    per_path = dict(zip(PATHS, (
        sum(r["launches"] for r in tr), sharded[TRACE_NAME],
        daemon[TRACE_NAME], 0, traced_tb, cold[TRACE_NAME],
    )))
    kernels.append({
        "name": TRACE_NAME, "route": "cuda", "source": TRACE_SOURCE,
        "replaces": TRACE_REPLACES, "launches": per_path["scan"],
        "max_abs_err": max(menu_err[TRACE_NAME],
                           *(r["worst"] for r in tr)),
        "ms": sum(r["kernel_ms"] for r in tr),
        "plain_ms": sum(r["plain_ms"] for r in tr),
        "bound_ms": t_bound, "bound_by": t_by, "library_ms": None,
        "paths": {k: n for k, n in per_path.items() if n},
    })
    # the table synthesis: launches of phase 3's two scans, and of each
    # path whose reads carry IUPAC codes; times, error and bound phase 3c's
    per_path = dict(zip(PATHS, (
        ctx["table_launches"], sharded[TABLES_NAME], daemon[TABLES_NAME],
        0, 0, cold[TABLES_NAME],
    )))
    kernels.append({**tables_row, "launches": per_path["scan"],
                    "paths": {k: n for k, n in per_path.items() if n}})
    print(trace_summary)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
