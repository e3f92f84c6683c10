"""Packing, plain recurrence and launch of the Hopper kernels.

The counterpart of the host side of deciphon_tpu/ops/viterbi_pallas.py:
``_pack_trans`` (:792), ``pack_block`` (:842), ``pack_block_compact``
(:894), ``PallasBlock.from_profiles`` (:1392) and the launch
(``run_scores_raw`` :1153), for the Viterbi kernel in csrc/viterbi.cu
and the forward kernel in csrc/forward.cu.

The kernels' own layout, per block of B profiles padded to K nodes:
  fm     [B, ntab, K]  match fragment tables (log), rows contiguous along
                       K (ntab = 1365 for ACGT reads, 3906 / 9331 / ...
                       for reads holding 1 / 2 / ... IUPAC codes)
  fin    [B, 2, ntab]  insert and null fragment tables (log)
  trans  [B, 8, K]     log planes ENTRY, MM_OUT, IM_OUT, DM_OUT, MI, II,
                       ABASE, CDD (viterbi_pallas.py:119): the Viterbi
                       kernel's, and the plain version's
  ptrans [B, 8, K]     probability planes ENTRY, MM_OUT, IM_OUT, DM_OUT,
                       MI, II, MD_OUT, DD_OUT: the forward kernel's
K is a multiple of LANE so every thread's node group is one aligned
float4.  None of the TPU layout (sublane groups, segments, slot spans,
VMEM streaming, SMEM chunks) carries over.

``scores_plain`` is the recurrence in plain torch on any device, under
either semiring ("max" = Viterbi, "logsumexp" = forward); it is the
port's one plain version of the kernel.  ``scores`` runs it for CPU
tensors and launches the kernel for CUDA tensors, with no fallback.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from deciphon_tpu_torch.ops.tables import block_tables
from deciphon_tpu_torch.ops.viterbi_torch import NEG, TRANS_NAMES, specials
from deciphon_tpu_torch.utils import trace

(P_ENTRY, P_MM_OUT, P_IM_OUT, P_DM_OUT, P_MI, P_II, P_ABASE, P_CDD) = range(8)
# the forward kernel's planes of ptrans (csrc/forward.cu), source-indexed
(Q_ENTRY, Q_MM_OUT, Q_IM_OUT, Q_DM_OUT, Q_MI, Q_II, Q_MD_OUT,
 Q_DD_OUT) = range(8)
NPLANES = 8
LANE = 32  # node padding unit of the packed K axis
MAX_K = 4096  # the reference's core-size envelope (core/limits.h:11)

SEMIRINGS = ("max", "logsumexp")
# kernel launches made by scores(), per semiring (viterbi_max for "max",
# viterbi_lse for "logsumexp"); callers that must show a run went through a kernel
# set the counts to 0 before the run and read them after
LAUNCHES = dict.fromkeys(SEMIRINGS, 0)
# a scan's counter of each semiring's launches (utils/trace)
COUNTERS = {"max": "launch.viterbi", "logsumexp": "launch.forward"}


class CompactInputs(NamedTuple):
    """A block's compact inputs of table synthesis on its device
    (``pack_emissions``' arrays): rows [0, B*kpad) are the nodes b*kpad
    + k, rows B*kpad + 2b + {0, 1} profile b's insert and null
    distributions (zero probabilities on padding nodes).  Those of
    extended tables (codon probabilities) do not depend on the codes, so
    a store builds them once (ops/scan_engine.Tables)."""

    emis: torch.Tensor  # [B*kpad + 2B, W] codon marginals or probabilities
    qp: torch.Tensor  # [B*kpad + 2B, 5] background probabilities
    B: int
    kpad: int
    eps: float

    @classmethod
    def from_profiles(cls, profiles, kpad: int, device) -> "CompactInputs":
        """The inputs of extended tables: codon probabilities."""
        emis, qp, ine, inq = pack_emissions(profiles, pad_width(kpad),
                                            codonp=True)
        return cls.upload(emis, qp, ine, inq,
                          float(profiles[0].cfg.epsilon), device)

    @classmethod
    def upload(cls, emis, qp, ine, inq, eps, device) -> "CompactInputs":
        """From ``pack_emissions``' host arrays, in one copy each."""
        B, Kp, W = emis.shape
        rows = np.concatenate([emis.reshape(-1, W), ine.reshape(-1, W)])
        q = np.concatenate([qp.reshape(-1, 5), inq.reshape(-1, 5)])
        return cls(torch.from_numpy(rows).to(device),
                   torch.from_numpy(q).to(device), B, Kp, eps)

    def rows(self, b0: int, b1: int) -> "CompactInputs":
        """The inputs of profiles b0 .. b1-1 alone, in the same layout:
        their node rows, then their insert and null rows."""
        n, k = self.B * self.kpad, self.kpad

        def take(t):
            return torch.cat([t[b0 * k : b1 * k], t[n + 2 * b0 : n + 2 * b1]])

        return CompactInputs(take(self.emis), take(self.qp), b1 - b0, k,
                             self.eps)

    def tables(self, codes: tuple = ()):
        """(fm [B, ntab, kpad], fin [B, 2, ntab]) of read class ``codes``
        (ops/tables.block_tables: csrc/tables.cu for extended tables on
        a card)."""
        return block_tables(self.emis, self.qp, self.eps, codes, self.B,
                            self.kpad)


class CudaBlock(NamedTuple):
    """One block of profiles packed in the kernel's layout."""

    fm: torch.Tensor  # [B, ntab, K]
    fin: torch.Tensor  # [B, 2, ntab]
    trans: torch.Tensor  # [B, NPLANES, K] log planes
    ptrans: torch.Tensor  # [B, NPLANES, K] probability planes

    @property
    def kpad(self) -> int:
        return self.fm.shape[2]

    @property
    def nbytes(self) -> int:
        """Device bytes of the four tensors."""
        return sum(t.numel() * t.element_size() for t in self)

    def rows(self, b0: int, b1: int) -> "CudaBlock":
        """Profiles b0 .. b1-1: views of the four tensors along B."""
        return CudaBlock(*(t[b0:b1] for t in self))

    @classmethod
    def from_profiles(cls, profiles, kpad: int | None = None,
                      device="cuda", codes: tuple = ()) -> "CudaBlock":
        """Build with the fragment tables synthesized on ``device`` from
        the compact per-node inputs (ops/tables.py) — the counterpart of
        PallasBlock.from_profiles.  Non-empty ``codes`` builds the
        extended base-(4+D) tables of reads holding those IUPAC codes,
        from inputs packed and uploaded for this block alone (a scan's
        store keeps them resident instead: ``extended``)."""
        emis, qp, ine, inq, trans, ptrans, eps = pack_compact(
            profiles, kpad, codes
        )
        dev = torch.device(device)
        inputs = CompactInputs.upload(emis, qp, ine, inq, eps, dev)
        return cls(*inputs.tables(codes), torch.from_numpy(trans).to(dev),
                   torch.from_numpy(ptrans).to(dev))

    @classmethod
    def extended(cls, inputs: CompactInputs, base: "CudaBlock",
                 codes: tuple) -> "CudaBlock":
        """The extended block of read class ``codes`` from a store's
        resident ``inputs``; the transition planes, which do not depend
        on the codes, are the base-4 block's own tensors.  For a profile
        slice, ``inputs.rows`` and ``base.rows`` of the same profiles."""
        return cls(*inputs.tables(codes), base.trans, base.ptrans)


def pad_width(k: int) -> int:
    """Packed node width for a core of ``k`` nodes."""
    return max(LANE, -(-k // LANE) * LANE)


def _out_of(a: np.ndarray) -> np.ndarray:
    """Destination-indexed trans[k] (from node k-1) -> source-indexed
    (to node k+1), NEG past the last node."""
    return np.concatenate(
        [a[:, 1:], np.full((a.shape[0], 1), NEG, a.dtype)], axis=1
    )


def pack_trans(arrs: dict[str, np.ndarray], dtype=np.float32) -> np.ndarray:
    """[B, NPLANES, K] log transition planes from destination-indexed
    [B, K] per-node vectors (already padded with NEG), in ``dtype``."""
    dd = arrs["dd_in"]
    B = dd.shape[0]
    # Dead DD links clamp to a moderate floor, not ~NEG: the telescoped
    # D-chain (VD = cdd + cummax(VM + md - cdd)) relies on cdd cancelling,
    # and -1e24-scale links would turn every later term into a +-1e24
    # pair whose f32 rounding swallows the real scores.  At -1e4 one
    # dead link still outweighs any real path by thousands of nats
    # (viterbi_pallas.py:799-811).
    dd_safe = np.maximum(dd, -1e4)
    dd_safe[:, 0] = 0.0
    cdd = np.cumsum(dd_safe, axis=1, dtype=np.float64).astype(dtype)
    neg1 = np.full((B, 1), NEG, dtype)
    md_next = np.concatenate([arrs["md_in"][:, 1:], neg1], axis=1)
    cdd_next = np.concatenate([cdd[:, 1:], cdd[:, -1:]], axis=1)
    a_base = np.maximum(md_next - cdd_next, NEG)
    return np.stack(
        [
            arrs["entry"], _out_of(arrs["mm_in"]), _out_of(arrs["im_in"]),
            _out_of(arrs["dm_in"]), arrs["mi"], arrs["ii"], a_base, cdd,
        ],
        axis=1,
    ).astype(dtype)


def pack_prob_trans(arrs: dict[str, np.ndarray]) -> np.ndarray:
    """[B, NPLANES, K] probability planes of the forward kernel from the
    same per-node vectors as ``pack_trans``: exp of each f32 log
    transition, taken in f64, source-indexed like the log planes.  Dead
    links and padding (NEG) are exactly 0, so the D-chain needs neither
    the telescoped cdd nor its -1e4 clamp.  The f32 log values are the
    ones the log planes and the plain version hold, so both packers give
    the same bits."""
    logp = np.stack(
        [
            arrs["entry"], _out_of(arrs["mm_in"]), _out_of(arrs["im_in"]),
            _out_of(arrs["dm_in"]), arrs["mi"], arrs["ii"],
            _out_of(arrs["md_in"]), _out_of(arrs["dd_in"]),
        ],
        axis=1,
    )
    return np.exp(logp.astype(np.float64)).astype(np.float32)


def pack_numpy_block(block, dtype=np.float32) -> CudaBlock:
    """CPU CudaBlock from a host ProfileBlock (viterbi_torch's: numpy
    fields fm [B, K, ntab], fi, fn and the [B, K] transitions), padded
    to a LANE multiple of nodes; tables and log planes in ``dtype`` (f32
    for the kernels; f64 for the plain version held against the f64
    oracle), probability planes in f32."""
    fm = np.asarray(block.fm, dtype)
    B, K, ntab = fm.shape
    Kp = pad_width(K)
    fm_p = np.full((B, ntab, Kp), NEG, dtype)
    fm_p[:, :, :K] = fm.transpose(0, 2, 1)
    fin = np.stack(
        [np.asarray(block.fi, dtype), np.asarray(block.fn, dtype)],
        axis=1,
    )
    arrs = {}
    for name in TRANS_NAMES:
        a = np.full((B, Kp), NEG, dtype)
        a[:, :K] = np.asarray(getattr(block, name), dtype)
        arrs[name] = a
    return CudaBlock(
        torch.from_numpy(fm_p), torch.from_numpy(fin),
        torch.from_numpy(pack_trans(arrs, dtype)),
        torch.from_numpy(pack_prob_trans(arrs)),
    )


def pack_emissions(profiles, Kp: int, codonp: bool = False):
    """(emis [B, Kp, W], qp [B, Kp, 5], ine [B, 2, W], inq [B, 2, 5]) f32,
    the per-node emission inputs of table synthesis: row 0 of ine/inq is
    the insert distribution, row 1 the null one; ``emis`` holds the codon
    marginals (W = 125), or with ``codonp`` the codon probabilities (W =
    64) that extended tables take.  Padding nodes hold zero
    probabilities (log 0 -> NEG on the device)."""
    B = len(profiles)
    kind, W = ("codonp", 64) if codonp else ("marg", 125)
    emis = np.zeros((B, Kp, W), np.float32)
    qp = np.zeros((B, Kp, 5), np.float32)
    ine = np.zeros((B, 2, W), np.float32)
    inq = np.zeros((B, 2, 5), np.float32)
    for b, p in enumerate(profiles):
        k = p.core_size
        emis[b, :k] = np.exp(getattr(p, f"match_{kind}"))
        qp[b, :k] = np.exp(p.match_q)
        ine[b, 0] = np.exp(getattr(p, f"insert_{kind}"))
        inq[b, 0] = np.exp(p.insert_q)
        ine[b, 1] = np.exp(getattr(p, f"null_{kind}"))
        inq[b, 1] = np.exp(p.null_q)
    return emis, qp, ine, inq


def pack_compact(profiles, kpad: int | None = None, codes: tuple = ()):
    """Host side of device table synthesis: compact per-node emission
    inputs instead of full tables (viterbi_pallas.pack_block_compact).

    Returns (emis, qp, ine, inq) of ``pack_emissions`` (the codon
    probabilities when ``codes`` asks for extended tables), then
    (trans [B, NPLANES, Kp], ptrans [B, NPLANES, Kp], eps)."""
    K = max(p.core_size for p in profiles)
    if kpad is not None:
        assert kpad >= K
        K = kpad
    Kp = pad_width(K)
    B = len(profiles)
    arrs = {n: np.full((B, Kp), NEG, np.float32) for n in TRANS_NAMES}
    for b, p in enumerate(profiles):
        for name, arr in arrs.items():
            arr[b, :p.core_size] = np.maximum(
                np.asarray(getattr(p, name), np.float64), NEG
            )
    eps = float(profiles[0].cfg.epsilon)
    return (*pack_emissions(profiles, Kp, codonp=bool(codes)),
            pack_trans(arrs), pack_prob_trans(arrs), eps)


# The Viterbi kernel's instantiations (csrc/viterbi.cu
# DCP_VITERBI_KERNELS): (nodes a lane, warps bound, rings in registers);
# a warps bound of 1 is a one-warp kernel, K = 32 * nodes a lane, with up
# to MAX_READS reads (one warp each) a CTA.
VITERBI_KERNELS = (
    (1, 1, True), (2, 1, True), (3, 1, True), (4, 1, True), (5, 1, True),
    (6, 1, True), (7, 1, True), (8, 1, True), (9, 1, False),
    (10, 1, False), (11, 1, False), (12, 1, False), (4, 8, False),
    (8, 8, False), (8, 16, False),
)
MAX_READS = 8
# resident CTAs an SM must hold under the kernels' __launch_bounds__
# (csrc/viterbi.cu's defaults of DCP_VIT_WARP_MINB and DCP_VIT_CTA_MINB,
# the latter for the 4-node CTA kernel; 1 for the others)
WARP_MINB, CTA_MINB = 1, 2
# the launch plan's defaults (ops/tune_npt.py sweeps them on the card)
WARP_MAX_K = 384  # one warp per (read, profile) up to this width
READS_PER_CTA = 4  # reads (warps) per CTA of the one-warp plans


class ViterbiPlan(NamedTuple):
    """Launch shape of the Viterbi kernel for one padded width."""

    npt: int  # consecutive nodes a lane
    kernel_warps: int  # the instantiation's warps bound; 1: one-warp kernel
    reg_ring: bool  # lookback rings in registers (else shared memory)
    warps: int  # warps per (read, profile)
    reads: int  # reads per CTA
    threads: int  # threads per CTA
    smem: int  # dynamic shared bytes per CTA (the rings, if not in registers)
    regs: int  # registers a thread may take under its __launch_bounds__

    def grid(self, S: int, B: int) -> tuple[int, int]:
        """(x, y) CTAs for S reads and B profiles."""
        return -(-S // self.reads), B


def viterbi_plan(K: int, warp_max_k: int = WARP_MAX_K,
                 reads: int = READS_PER_CTA) -> ViterbiPlan:
    """The Viterbi kernel's launch shape for padded width K (a multiple
    of LANE up to MAX_K):
      - K <= warp_max_k (at most 384): one warp per (read, profile),
        K / 32 nodes a lane, ``reads`` reads a CTA, no barrier, rings in
        registers up to 8 nodes a lane and in shared memory above;
      - K <= 1024: a CTA of ceil(K / 128) warps per read, 4 nodes a lane;
      - wider: 8 nodes a lane, up to 8 warps (K <= 2048) or 16
        (K <= 4096).
    CTA plans keep their rings in shared memory.  The planes are in
    registers on every plan.  The defaults are the card's best of
    ops/tune_npt.py's sweep (PERF.md)."""
    if K % LANE or not 0 < K <= MAX_K:
        raise ValueError(f"K={K}: need a multiple of {LANE} up to {MAX_K}")
    if not 1 <= reads <= MAX_READS:
        raise ValueError(f"reads={reads}: need 1..{MAX_READS}")
    if K <= warp_max_k and K // LANE <= 12:
        # 10 x npt more registers for the rings fit up to 8 nodes a lane
        npt, bound, warps = K // LANE, 1, 1
        ring = npt <= 8
    else:
        reads, ring = 1, False
        npt, bound = (4, 8) if K <= 1024 else (8, 8 if K <= 2048 else 16)
        warps = -(-K // (LANE * npt))
    assert (npt, bound, ring) in VITERBI_KERNELS
    cta_bound = LANE * (MAX_READS if bound == 1 else bound)
    minb = (WARP_MINB if bound == 1 else
            CTA_MINB if (npt, bound) == (4, 8) else 1)
    return ViterbiPlan(
        npt=npt, kernel_warps=bound, reg_ring=ring, warps=warps,
        reads=reads, threads=LANE * warps * reads,
        smem=0 if ring else reads * 2 * 5 * K * 4,
        regs=min(255, 65536 // (cta_bound * minb)),
    )


# rows of the specials ring (VB enters the DP only through ring_cs)
S_N, S_J, S_C, S_E, S_R = range(5)


def _logaddexp(a, b):
    """log(exp(a) + exp(b)) of finite a and b, from exp and log1p: on the
    CPU their kernels give an element the same bits wherever it lies in
    a tensor, where torch.logaddexp's vector body and scalar tail differ,
    so that a (read, profile) cell does not depend on which other
    profiles share its block."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _logsumexp(x, dim: int):
    """torch.logsumexp over the last dim; over dim 0 (the five lookback
    slots) a sum of the slots in order, for the reason of _logaddexp."""
    if dim != 0:
        return torch.logsumexp(x, dim)
    m = torch.amax(x, 0)
    e = torch.exp(x - m).unbind(0)
    acc = e[0]
    for t in e[1:]:
        acc = acc + t
    return m + torch.log(acc)


def _semiring(name: str):
    """(join, reduce over a dim, inclusive prefix scan along the last
    dim): max = Viterbi, logsumexp = forward (viterbi_pallas.py:165)."""
    if name == "max":
        return (torch.maximum, torch.amax,
                lambda x: torch.cummax(x, dim=-1).values)
    if name == "logsumexp":
        return (_logaddexp, _logsumexp,
                lambda x: torch.logcumsumexp(x, dim=-1))
    raise ValueError(f"unknown semiring {name!r}")


def scores_plain(
    blk: CudaBlock,
    eidx: torch.Tensor,  # [S, Lp, 5] int32 end-fragment indices
    seq_len: torch.Tensor,  # [S] int32
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    semiring: str = "max",
    dtype: torch.dtype = torch.float32,
):
    """Plain torch version of the kernel: (alt [S, B], null [S, B]) in
    ``dtype``: f32, the kernels' width, or f64, which casts the block's
    tables and planes and runs every buffer and special transition in
    f64 (the yardstick for long reads, where f32 rounding accumulates).

    The recurrence of viterbi_pallas._kernel, batched over [S reads,
    B profiles, K nodes] with a Python loop over positions: a 5-slot
    lookback ring of the core in-flow (with B->entry folded in at write
    time), the N/J/C/R specials from each read's length, the D-chain as a
    telescoped prefix scan and the capture of alt = T and null = R at
    i == seq_len.  Under "max" the joins are maxima and the scan a
    cummax; under "logsumexp" they are logaddexp, logsumexp and
    logcumsumexp.  The NEG clamp of the D-chain is the same in both."""
    join, red, cum = _semiring(semiring)
    fm, fin, trans = (t.to(dtype) for t in (blk.fm, blk.fin, blk.trans))
    B, _, K = fm.shape
    S = eidx.shape[0]
    dev = fm.device
    seq_len = seq_len.to(dev)
    eidx = eidx.to(dev).long()
    xt = specials(seq_len, multi_hits, hmmer3_compat, dtype)
    t_NN, t_NB, t_RR = (xt[k][:, None] for k in ("NN", "NB", "RR"))
    t_EJ, t_EC = xt["EJ"], xt["EC"]
    entry, mm_out, im_out, dm_out, mi, ii, a_base, cdd = trans.unbind(1)

    negk = torch.full((S, B, K), NEG, dtype=dtype, device=dev)
    neg1 = torch.full((S, B, 1), NEG, dtype=dtype, device=dev)
    # position 0: S -> B -> entry (VB[0] = t_NB), every other slot dead
    ring_cs = [t_NB[:, :, None] + entry] + [negk] * 4
    ring_ic = [negk] * 5
    ring_s = [torch.full((5, S, B), NEG, dtype=dtype, device=dev)] * 5
    alt = torch.full((S, B), NEG, dtype=dtype, device=dev)
    null = alt.clone()
    lookback = torch.arange(1, 6, device=dev)[:, None, None]
    Lmax = min(int(seq_len.max()), eidx.shape[1]) if S else 0
    for i in range(1, Lmax + 1):
        idx = eidx[:, i - 1, :]  # [S, 5]
        em_m = fm[:, idx, :]  # [B, S, 5, K]
        em_in = fin[:, :, idx]  # [B, 2, S, 5]
        accM = accI = None
        for l in range(1, 6):
            slot = (i - l) % 5
            cm = ring_cs[slot] + em_m[:, :, l - 1].transpose(0, 1)
            ci = ring_ic[slot] + em_in[:, 0, :, l - 1].T[:, :, None]
            accM = cm if accM is None else join(accM, cm)
            accI = ci if accI is None else join(accI, ci)
        sp5 = torch.stack([ring_s[(i - l) % 5] for l in range(1, 6)])
        en5 = em_in[:, 1].permute(2, 1, 0)  # [5, S, B]
        # start gate: position i-l == 0 (the S state) only when l == i
        start5 = torch.where(lookback == i, 0.0, NEG).to(dtype)
        accN = red(join(sp5[:, S_N], start5) + t_NN + en5, 0)
        accJ = red(join(sp5[:, S_E] + t_EJ, sp5[:, S_J]) + t_NN + en5, 0)
        accC = red(join(sp5[:, S_E] + t_EC, sp5[:, S_C]) + t_NN + en5, 0)
        accR = red(join(sp5[:, S_R] + t_RR, start5) + en5, 0)

        # mute D-chain: VD = cdd + (prefix scan of VM + a_base, shifted)
        b = cum(accM + a_base)
        VD = torch.clamp_min(cdd + torch.cat([neg1, b[..., :-1]], -1), NEG)
        VE = red(join(accM, VD), -1)
        VB = join(accN + t_NB, join(VE + t_EJ + t_NB, accJ + t_NB))
        VT = join(VE + t_EC + t_NB, accC + t_NB)
        hit = (seq_len == i)[:, None]
        alt = torch.where(hit, VT, alt)
        null = torch.where(hit, accR, null)

        core = join(accM + mm_out, join(accI + im_out, VD + dm_out))
        core_sh = torch.cat([neg1, core[..., :-1]], -1)
        ring_cs[i % 5] = join(core_sh, VB[..., None] + entry)
        ring_ic[i % 5] = join(accM + mi, accI + ii)
        ring_s[i % 5] = torch.stack([accN, accJ, accC, VE, accR])
    return alt, null


def scores(
    blk: CudaBlock,
    eidx: torch.Tensor,
    seq_len: torch.Tensor,
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    semiring: str = "max",
):
    """(alt [S, B], null [S, B]) f32: the plain version for a block on
    the CPU, the CUDA kernel of ``semiring`` for a block on the card
    (csrc/viterbi.cu for "max", csrc/forward.cu for "logsumexp")."""
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    if not blk.fm.is_cuda:
        return scores_plain(
            blk, eidx, seq_len, multi_hits, hmmer3_compat, semiring
        )
    return _launch(blk, eidx, seq_len, multi_hits, hmmer3_compat, semiring)


def _launch(blk, eidx, seq_len, multi_hits, hmmer3_compat, semiring,
            plan: ViterbiPlan | None = None):
    """Launch the kernel of ``semiring`` on the card; ``plan`` replaces
    the Viterbi kernel's launch shape (by default ``viterbi_plan(K)``),
    as ops/tune_npt.py does to compare shapes."""
    from deciphon_tpu_torch.ops import _build

    fm, fin = blk.fm, blk.fin
    # the Viterbi kernel reads the log planes, the forward kernel the
    # probability planes, in the same argument slot
    trans = blk.trans if semiring == "max" else blk.ptrans
    B, ntab, K = fm.shape
    S, Lp, five = eidx.shape
    dev = fm.device
    for name, t, dt in (
        ("fm", fm, torch.float32), ("fin", fin, torch.float32),
        ("trans", trans, torch.float32), ("eidx", eidx, torch.int32),
        ("seq_len", seq_len, torch.int32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous {dt} tensor on {dev}, got "
                f"{t.dtype} on {t.device}"
            )
    if five != 5 or tuple(seq_len.shape) != (S,):
        raise ValueError(f"eidx {tuple(eidx.shape)} / seq_len "
                         f"{tuple(seq_len.shape)}: need [S, Lp, 5] / [S]")
    if tuple(fin.shape) != (B, 2, ntab) or tuple(trans.shape) != (
        B, NPLANES, K
    ):
        raise ValueError("fin/trans do not match fm's [B, ntab, K]")
    if K % LANE or not 0 < K <= MAX_K:
        raise ValueError(f"K={K}: need a multiple of {LANE} up to {MAX_K}")
    if B > 65535:
        raise ValueError(f"B={B} profiles exceed the grid's y extent")
    xt = specials(seq_len, multi_hits, hmmer3_compat)
    sp = torch.stack([xt["NN"], xt["NB"], xt["RR"]], dim=1).contiguous()
    alt = torch.empty((S, B), dtype=torch.float32, device=dev)
    null = torch.empty((S, B), dtype=torch.float32, device=dev)
    if S == 0 or B == 0:
        return alt, null
    lib = _build.library()
    args = (
        fm.data_ptr(), fin.data_ptr(), trans.data_ptr(),
        eidx.data_ptr(), seq_len.data_ptr(), sp.data_ptr(),
        ctypes.c_float(xt["EJ"]), ctypes.c_float(xt["EC"]),
        alt.data_ptr(), null.data_ptr(), S, B, K, ntab, Lp,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if semiring == "max":
            p = plan or viterbi_plan(K)
            rc = lib.dcp_viterbi_max(
                *args, p.npt, p.kernel_warps, int(p.reg_ring), p.warps,
                p.reads, p.smem, stream,
            )
        else:
            rc = lib.dcp_viterbi_lse(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"viterbi kernel ({semiring}) launch failed: "
            f"{_build.error_string(rc)}"
        )
    LAUNCHES[semiring] += 1
    trace.count(COUNTERS[semiring])
    return alt, null
