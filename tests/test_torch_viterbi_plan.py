"""The Viterbi kernel's launch plan (viterbi_cuda.viterbi_plan), on the CPU.

The kernel (csrc/viterbi.cu) cannot run here, so its launch shape is
computed in Python and checked for every padded width 32..4096: each
node is owned by exactly one lane, the CTA fits the card (threads,
shared bytes, registers under the instantiation's __launch_bounds__),
the grid fits its extents, and each plan names an instantiation that
the source compiles.
"""

import re
from pathlib import Path

import pytest

from deciphon_tpu_torch.ops import tune_npt
from deciphon_tpu_torch.ops import viterbi_cuda as vc

WIDTHS = range(vc.LANE, vc.MAX_K + 1, vc.LANE)
SOURCE = (Path(vc.__file__).resolve().parent.parent / "csrc" / "viterbi.cu")
SMEM_MAX = 232448  # bytes a CTA may take on an H100
STATIC_SMEM = 3 * 16 * 4  # warp_tot, warp_max, warp_core of 16 warps
# every set of thresholds the plan is built from: the defaults and the
# variants ops/tune_npt.py sweeps on the card
OVERRIDES = [kw for _, kw in tune_npt.VIT_VARIANTS.values()]


def _plans():
    for kw in OVERRIDES:
        for K in WIDTHS:
            yield K, kw, vc.viterbi_plan(K, **kw)


def test_each_node_owned_by_one_lane():
    for K, kw, p in _plans():
        lanes = vc.LANE * p.warps
        owner = [None] * K
        for t in range(lanes):
            for k in range(t * p.npt, min(K, (t + 1) * p.npt)):
                assert owner[k] is None, (K, kw, k)
                owner[k] = t
        assert None not in owner, (K, kw)
        # every warp holds nodes, and a one-warp plan fills every lane
        assert (p.warps - 1) * vc.LANE * p.npt < K, (K, kw)
        if p.kernel_warps == 1:
            assert K == vc.LANE * p.npt, (K, kw)


def test_cta_fits_the_card():
    for K, kw, p in _plans():
        bound = vc.LANE * (vc.MAX_READS if p.kernel_warps == 1
                           else p.kernel_warps)
        assert p.threads == vc.LANE * p.warps * p.reads <= bound <= 1024
        assert p.warps <= p.kernel_warps or p.kernel_warps == 1
        assert p.reads == 1 or p.kernel_warps == 1
        assert p.smem == (0 if p.reg_ring else p.reads * 2 * 5 * K * 4)
        assert p.smem + STATIC_SMEM <= SMEM_MAX, (K, kw)
        # the register file holds the resident CTAs __launch_bounds__
        # asks for, at the registers it leaves a thread (steps of 8)
        minb = (vc.WARP_MINB if p.kernel_warps == 1 else
                vc.CTA_MINB if (p.npt, p.kernel_warps) == (4, 8) else 1)
        assert p.regs <= 255
        assert -(-p.regs // 8) * 8 * bound * minb <= 65536, (K, kw)


def test_register_budget_of_each_instantiation():
    """The plan's registers are those the source's __launch_bounds__
    leave a thread: its default resident-CTA counts, mirrored in
    viterbi_cuda, give 255 (one warp; 8 nodes, 8 warps) and 128 (4
    nodes, 8 warps; 8 nodes, 16 warps)."""
    text = SOURCE.read_text()
    for name, val in (("DCP_VIT_WARP_MINB", vc.WARP_MINB),
                      ("DCP_VIT_CTA_MINB", vc.CTA_MINB)):
        assert int(re.search(rf"#define {name} (\d+)", text).group(1)) == val
    assert re.search(r"W == 1\s*\?\s*DCP_VIT_WARP_MINB\s*"
                     r":\s*NPT == 4 && W == 8\s*\?\s*DCP_VIT_CTA_MINB", text)
    want = {(1, 1): 255, (12, 1): 255, (4, 8): 128, (8, 8): 255,
            (8, 16): 128}
    got = {(p.npt, p.kernel_warps): p.regs
           for p in map(vc.viterbi_plan, (32, 384, 1024, 2048, 4096))}
    assert got == want


@pytest.mark.parametrize("S", [1, 7, 8, 65535])
@pytest.mark.parametrize("B", [1, 65535])
def test_grid_within_extents(S, B):
    for K, kw, p in _plans():
        x, y = p.grid(S, B)
        assert 1 <= x <= 2**31 - 1 and 1 <= y <= 65535
        assert x * p.reads >= S > (x - 1) * p.reads
        assert y == B


def test_plans_compile_in_the_source():
    """Every plan names an instantiation of DCP_VITERBI_KERNELS, and the
    Python mirror lists exactly those."""
    text = SOURCE.read_text()
    body = text[text.index("#define DCP_VITERBI_KERNELS"):]
    body = body[:body.index("\n\n")]
    compiled = {
        (int(n), int(w), r == "true")
        for n, w, r in re.findall(r"X\((\d+), (\d+), (true|false)\)", body)
    }
    assert compiled == set(vc.VITERBI_KERNELS)
    reads = re.search(r"constexpr int MAX_READS = (\d+);", text)
    assert int(reads.group(1)) == vc.MAX_READS
    for K, kw, p in _plans():
        assert (p.npt, p.kernel_warps, p.reg_ring) in compiled, (K, kw)
    # and the sweep's variants reach every one of them
    assert {p[:3] for _, _, p in _plans()} == compiled


def test_default_plans_named_in_perf():
    """The plans PERF.md names for the widths of its per-block table."""
    want = {
        128: (4, 1, True, 1, 4, 128, 0),
        160: (5, 1, True, 1, 4, 128, 0),
        2048: (8, 8, False, 8, 1, 256, 81920),
        4096: (8, 16, False, 16, 1, 512, 163840),
    }
    for K, shape in want.items():
        assert tuple(vc.viterbi_plan(K))[:7] == shape, K


@pytest.mark.parametrize("K,kw", [(0, {}), (33, {}), (4128, {}),
                                  (64, {"reads": 0}), (64, {"reads": 9})])
def test_bad_plan_raises(K, kw):
    with pytest.raises(ValueError):
        vc.viterbi_plan(K, **kw)
