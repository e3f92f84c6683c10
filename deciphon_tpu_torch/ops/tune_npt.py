"""Compare launch shapes of the Hopper kernels on the card.

    python -m deciphon_tpu_torch.ops.tune_npt viterbi   # one CUDA card
    python -m deciphon_tpu_torch.ops.tune_npt forward
    python -m deciphon_tpu_torch.ops.tune_npt           # both

Both sweeps time blocks of NPROF profiles of one core size at a time,
for two read classes: 256 ACGT reads of 150-500 nt (base-4 tables) and 8
reads holding N and R (base-6 tables).  They print the card and one line
per (class, K) with the milliseconds of each variant (min of 3, CUDA
events).

Viterbi (csrc/viterbi.cu): its launch shape is a plan that the wrapper
passes at launch (viterbi_cuda.viterbi_plan), so one build serves the
plan variants of VIT_VARIANTS: the width up to which one warp runs a
(read, profile) and the reads per CTA of the one-warp plans; other
variants are builds with the kernel's register budgets changed
(DCP_VIT_WARP_MINB, DCP_VIT_CTA_MINB).
A variant whose build and plan equal an earlier one's prints "=".  Every
variant's scores must equal the default's bit for bit.

Forward (csrc/forward.cu): the kernel runs 4 nodes a thread up to K =
DCP_FWD_NPT4_MAX_K and 8 above, and at 4 nodes a thread asks ptxas for
DCP_FWD_NPT4_MIN_BLOCKS resident CTAs of 512 threads (1: up to 128
registers, 2: at most 64).  This builds it once per entry of VARIANTS,
holds every build's scores against the first build's (|d| <= 1e-3 +
1e-5 |x|).  Each build's registers and spills are printed.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from deciphon_tpu_torch.models.profile import sample_profile
from deciphon_tpu_torch.ops import _build
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops.emissions import fragment_indices
from deciphon_tpu_torch.ops.viterbi_torch import end_fragment_indices

# name -> (extra nvcc flags, viterbi_plan thresholds); "default" is the
# package's own build and plan
VIT_VARIANTS = {
    "default": ((), {}),
    "reads2": ((), {"reads": 2}),
    "reads8": ((), {"reads": 8}),
    "warp128": ((), {"warp_max_k": 128}),  # one warp up to K = 128 only
    "warp256": ((), {"warp_max_k": 256}),  # one warp up to K = 256 only
    "cta": ((), {"warp_max_k": 0}),  # CTA plans at every width
    # builds with other register budgets (csrc/viterbi.cu's macros)
    "wminb2": (("-DDCP_VIT_WARP_MINB=2",), {}),  # one-warp: <= 128 regs
    "cminb1": (("-DDCP_VIT_CTA_MINB=1",), {}),  # 4-node CTAs: <= 255
}
VIT_KS = (32, 64, 96, 128, 160, 192, 224, 256, 288, 384, 512, 576, 832,
          1024, 1216, 2048, 4096)
# name -> extra nvcc flags of the forward kernel; "default" is the
# package's own launch shape
VARIANTS = {
    "npt8": ("-DDCP_FWD_NPT4_MAX_K=0",),
    "default": (),
    "npt4": ("-DDCP_FWD_NPT4_MAX_K=2048",),
    "64regs": ("-DDCP_FWD_NPT4_MIN_BLOCKS=2",),
}
KS = (32, 64, 96, 128, 160, 256, 512, 1024, 2048)
NPROF = 64  # profiles per block
CLASSES = {"ACGT": ((), 256), "N+R": (("N", "R"), 8)}


def reads_eidx(codes, n, rng, dev):
    """eidx [n, Lp, 5] and seq_len [n] of n random reads of 150-500 nt,
    with codes[0] near the start and codes[-1] mid-read."""
    lens = rng.integers(150, 501, n)
    base = 4 + len(codes)
    rows = []
    for ln in lens:
        r = rng.integers(0, 4, ln).astype(np.int8)
        for j in range(len(codes)):
            r[[3, ln // 2][j]] = 4 + j
        rows.append(end_fragment_indices(
            fragment_indices(r, pad_to=int(lens.max()), base=base), base))
    return (torch.from_numpy(np.stack(rows)).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev))


def timed_ms(fn, reps=3):
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


def main(argv: list[str]) -> None:
    which = argv or ["viterbi", "forward"]
    if not set(which) <= {"viterbi", "forward"}:
        raise SystemExit("usage: tune_npt [viterbi] [forward]")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    base_flags = _build.NVCC_FLAGS
    try:
        if "viterbi" in which:
            _sweep_viterbi(dev, base_flags)
        if "forward" in which:
            _sweep(dev, base_flags)
    finally:  # the package's own build again for any later caller
        _build.NVCC_FLAGS = base_flags
        _build._LIB = None


def _builds(flag_sets, base_flags) -> dict:
    """flags -> the kernels built with base_flags + flags, printing each
    build's registers and spills."""
    libs = {}
    for flags in dict.fromkeys(flag_sets):
        _build._LIB = None
        _build.NVCC_FLAGS = base_flags + flags
        libs[flags] = _build.library()
        for line in _build.BUILD_LOG.splitlines():
            if any(w in line for w in ("Compiling", "registers", "spill")):
                print(f"build {' '.join(flags) or 'default'}: "
                      f"{line.strip()}")
    return libs


def launch(blk, eidx, slen, plan):
    """The Viterbi kernel's (alt, null) on ``plan``, default flags."""
    return vc._launch(blk, eidx, slen, True, False, "max", plan)


def _sweep_viterbi(dev, base_flags) -> None:
    libs = _builds([f for f, _ in VIT_VARIANTS.values()], base_flags)
    rng = np.random.default_rng(5)
    print("viterbi class K: " + " ".join(f"ms@{v}" for v in VIT_VARIANTS))
    for name, (codes, nreads) in CLASSES.items():
        eidx, slen = reads_eidx(codes, nreads, rng, dev)
        for K in VIT_KS:
            profiles = [sample_profile(1000 * K + j, K) for j in range(NPROF)]
            blk = vc.CudaBlock.from_profiles(profiles, device=dev, codes=codes)
            seen, cells, ref = {}, [], None
            for t, (flags, kw) in VIT_VARIANTS.items():
                plan = vc.viterbi_plan(K, **kw)
                if (flags, plan) in seen:
                    cells.append("=")
                    continue
                _build._LIB = libs[flags]
                got = launch(blk, eidx, slen, plan)
                if ref is None:
                    ref = got
                if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                    raise SystemExit(f"viterbi variant {t} disagrees at K={K}")
                ms = timed_ms(lambda: launch(blk, eidx, slen, plan))
                seen[flags, plan] = ms
                cells.append(f"{ms:.3f}")
            print(f"viterbi {name} {K}: " + " ".join(cells))
            del blk
            torch.cuda.empty_cache()


def _sweep(dev, base_flags) -> None:
    libs = _builds(VARIANTS.values(), base_flags)
    rng = np.random.default_rng(5)
    print("forward class K: " + " ".join(f"ms@{v}" for v in VARIANTS))
    for name, (codes, nreads) in CLASSES.items():
        eidx, slen = reads_eidx(codes, nreads, rng, dev)
        for K in KS:
            profiles = [sample_profile(1000 * K + j, K) for j in range(NPROF)]
            blk = vc.CudaBlock.from_profiles(profiles, device=dev, codes=codes)
            ms, ref = {}, None
            for t, flags in VARIANTS.items():
                _build._LIB = libs[flags]
                alt, null = vc.scores(blk, eidx, slen, semiring="logsumexp")
                if ref is None:
                    ref = (alt, null)
                for got, want in zip((alt, null), ref):
                    tol = 1e-3 + 1e-5 * want.abs()
                    if not bool(((got - want).abs() <= tol).all()):
                        raise SystemExit(f"variant {t} disagrees at K={K}")
                ms[t] = timed_ms(lambda: vc.scores(blk, eidx, slen,
                                                   semiring="logsumexp"))
            print(f"forward {name} {K}: "
                  + " ".join(f"{ms[t]:.3f}" for t in VARIANTS))
            del blk
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
