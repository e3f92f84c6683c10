"""Compare launch shapes of the forward kernel (csrc/forward.cu) on the card.

    python -m deciphon_tpu_torch.ops.tune_forward_npt    # one CUDA card

The kernel runs 4 nodes a thread up to K = DCP_FWD_NPT4_MAX_K and 8
above, and at 4 nodes a thread asks ptxas for DCP_FWD_NPT4_MIN_BLOCKS
resident CTAs of 512 threads (1: up to 128 registers, 2: at most 64).
This builds it once per entry of VARIANTS and times each build on
blocks of one core size at a time, for two read classes: 256 ACGT reads
of 150-500 nt (base-4 tables) and 8 reads holding N and R (base-6
tables).  It prints the card, each build's registers and spills, and one
line per (class, K) with the milliseconds of each variant (min of 3,
CUDA events).  Every build's scores are held against the first
build's (|d| <= 1e-3 + 1e-5 |x|).
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from deciphon_tpu_torch.models.profile import sample_profile
from deciphon_tpu_torch.ops import _build
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops.emissions import fragment_indices
from deciphon_tpu_torch.ops.viterbi_torch import end_fragment_indices

# name -> extra nvcc flags; "default" is the package's own launch shape
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


def main() -> None:
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    base_flags = _build.NVCC_FLAGS
    try:
        _sweep(dev, base_flags)
    finally:  # the package's own build again for any later caller
        _build.NVCC_FLAGS = base_flags
        _build._LIB = None


def _sweep(dev, base_flags) -> None:
    libs = {}
    for name, flags in VARIANTS.items():
        _build._LIB = None
        _build.NVCC_FLAGS = base_flags + flags
        libs[name] = _build.library()
        log = _build.BUILD_LOG
        # ptxas's report of forward.cu only (its part ends at viterbi.cu's)
        for line in log[log.index("[forward.cu]"):].splitlines()[1:]:
            if "[viterbi.cu]" in line:
                break
            if any(w in line for w in ("Compiling", "registers", "spill")):
                print(f"{name}: {line.strip()}")
    rng = np.random.default_rng(5)
    print("class K: " + " ".join(f"ms@{v}" for v in VARIANTS))
    for name, (codes, nreads) in CLASSES.items():
        eidx, slen = reads_eidx(codes, nreads, rng, dev)
        for K in KS:
            profiles = [sample_profile(1000 * K + j, K) for j in range(NPROF)]
            blk = vc.CudaBlock.from_profiles(profiles, device=dev, codes=codes)
            ms, ref = {}, None
            for t in VARIANTS:
                _build._LIB = libs[t]
                alt, null = vc.scores(blk, eidx, slen, semiring="logsumexp")
                if ref is None:
                    ref = (alt, null)
                for got, want in zip((alt, null), ref):
                    tol = 1e-3 + 1e-5 * want.abs()
                    if not bool(((got - want).abs() <= tol).all()):
                        raise SystemExit(f"variant {t} disagrees at K={K}")
                ms[t] = timed_ms(lambda: vc.scores(blk, eidx, slen,
                                                   semiring="logsumexp"))
            print(f"{name} {K}: " + " ".join(f"{ms[t]:.3f}" for t in VARIANTS))
            del blk
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
