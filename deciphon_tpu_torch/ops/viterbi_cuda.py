"""Packing, plain recurrence and launch of the Hopper Viterbi kernel.

The counterpart of the host side of deciphon_tpu/ops/viterbi_pallas.py:
``_pack_trans`` (:792), ``pack_block`` (:842), ``pack_block_compact``
(:894), ``PallasBlock.from_profiles`` (:1392) and the launch
(``run_scores_raw`` :1153), for the kernel in csrc/viterbi.cu.

The kernel's own layout, per block of B profiles padded to K nodes:
  fm    [B, ntab, K]  match fragment tables, rows contiguous along K
                      (ntab = 1365 for ACGT reads, 3906 / 9331 / ...
                      for reads holding 1 / 2 / ... IUPAC codes)
  fin   [B, 2, ntab]  insert and null fragment tables
  trans [B, 8, K]     planes ENTRY, MM_OUT, IM_OUT, DM_OUT, MI, II,
                      ABASE, CDD (viterbi_pallas.py:119)
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

from deciphon_tpu_torch.ops.tables import synth_fragment_tables
from deciphon_tpu_torch.ops.viterbi_torch import NEG, TRANS_NAMES, specials

(P_ENTRY, P_MM_OUT, P_IM_OUT, P_DM_OUT, P_MI, P_II, P_ABASE, P_CDD) = range(8)
NPLANES = 8
LANE = 32  # node padding unit of the packed K axis
MAX_K = 4096  # the reference's core-size envelope (core/limits.h:11)

SEMIRINGS = ("max", "logsumexp")
# kernel launches made by scores(), per semiring (the kernel's two
# instantiations); callers that must show a run went through a kernel
# set the counts to 0 before the run and read them after
LAUNCHES = dict.fromkeys(SEMIRINGS, 0)


class CudaBlock(NamedTuple):
    """One block of profiles packed in the kernel's layout."""

    fm: torch.Tensor  # [B, ntab, K]
    fin: torch.Tensor  # [B, 2, ntab]
    trans: torch.Tensor  # [B, NPLANES, K]

    @property
    def kpad(self) -> int:
        return self.fm.shape[2]

    @classmethod
    def from_profiles(cls, profiles, kpad: int | None = None,
                      device="cuda", codes: tuple = ()) -> "CudaBlock":
        """Build with the fragment tables synthesized on ``device`` from
        the compact per-node inputs (ops/tables.py) — the counterpart of
        PallasBlock.from_profiles.  Non-empty ``codes`` builds the
        extended base-(4+D) tables of reads holding those IUPAC codes."""
        emis, qp, ine, inq, trans, eps = pack_compact(profiles, kpad, codes)
        B, K, W = emis.shape
        dev = torch.device(device)

        def synth(e, q):
            return synth_fragment_tables(
                torch.from_numpy(e.reshape(-1, W)).to(dev),
                torch.from_numpy(q.reshape(-1, 5)).to(dev), eps, codes,
            )

        fm = synth(emis, qp)
        ntab = fm.shape[1]
        fm = fm.reshape(B, K, ntab).transpose(1, 2).contiguous()
        fin = synth(ine, inq).reshape(B, 2, ntab)
        return cls(fm, fin, torch.from_numpy(trans).to(dev))


def pad_width(k: int) -> int:
    """Packed node width for a core of ``k`` nodes."""
    return max(LANE, -(-k // LANE) * LANE)


def pack_trans(arrs: dict[str, np.ndarray]) -> np.ndarray:
    """[B, NPLANES, K] transition planes from destination-indexed [B, K]
    per-node vectors (already padded with NEG)."""
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
    cdd = np.cumsum(dd_safe, axis=1, dtype=np.float64).astype(np.float32)
    neg1 = np.full((B, 1), NEG, np.float32)
    md_next = np.concatenate([arrs["md_in"][:, 1:], neg1], axis=1)
    cdd_next = np.concatenate([cdd[:, 1:], cdd[:, -1:]], axis=1)
    a_base = np.maximum(md_next - cdd_next, NEG)

    def out_of(name):
        # destination-indexed trans[k] (from node k-1) -> source-indexed
        return np.concatenate([arrs[name][:, 1:], neg1], axis=1)

    return np.stack(
        [
            arrs["entry"], out_of("mm_in"), out_of("im_in"),
            out_of("dm_in"), arrs["mi"], arrs["ii"], a_base, cdd,
        ],
        axis=1,
    ).astype(np.float32)


def pack_numpy_block(block) -> CudaBlock:
    """CPU CudaBlock from a host ProfileBlock (viterbi_torch's: numpy
    fields fm [B, K, ntab], fi, fn and the [B, K] transitions), padded
    to a LANE multiple of nodes."""
    fm = np.asarray(block.fm, np.float32)
    B, K, ntab = fm.shape
    Kp = pad_width(K)
    fm_p = np.full((B, ntab, Kp), NEG, np.float32)
    fm_p[:, :, :K] = fm.transpose(0, 2, 1)
    fin = np.stack(
        [np.asarray(block.fi, np.float32), np.asarray(block.fn, np.float32)],
        axis=1,
    )
    arrs = {}
    for name in TRANS_NAMES:
        a = np.full((B, Kp), NEG, np.float32)
        a[:, :K] = np.asarray(getattr(block, name), np.float32)
        arrs[name] = a
    return CudaBlock(
        torch.from_numpy(fm_p), torch.from_numpy(fin),
        torch.from_numpy(pack_trans(arrs)),
    )


def pack_compact(profiles, kpad: int | None = None, codes: tuple = ()):
    """Host side of device table synthesis: compact per-node emission
    inputs instead of full tables (viterbi_pallas.pack_block_compact).

    Returns (emis [B, Kp, W], qp [B, Kp, 5], ine [B, 2, W],
    inq [B, 2, 5], trans [B, NPLANES, Kp], eps); row 0 of ine/inq is the
    insert distribution, row 1 the null one.  ``emis`` holds the codon
    marginals (W = 125) for base-4 tables, and the codon probabilities
    (W = 64) when ``codes`` asks for extended ones."""
    B = len(profiles)
    K = max(p.core_size for p in profiles)
    if kpad is not None:
        assert kpad >= K
        K = kpad
    Kp = pad_width(K)
    kind, W = ("codonp", 64) if codes else ("marg", 125)
    emis = np.zeros((B, Kp, W), np.float32)
    qp = np.zeros((B, Kp, 5), np.float32)
    ine = np.zeros((B, 2, W), np.float32)
    inq = np.zeros((B, 2, 5), np.float32)
    arrs = {n: np.full((B, Kp), NEG, np.float32) for n in TRANS_NAMES}
    for b, p in enumerate(profiles):
        k = p.core_size
        # zero probabilities on padding nodes -> log 0 -> NEG on device
        emis[b, :k] = np.exp(getattr(p, f"match_{kind}"))
        qp[b, :k] = np.exp(p.match_q)
        ine[b, 0] = np.exp(getattr(p, f"insert_{kind}"))
        inq[b, 0] = np.exp(p.insert_q)
        ine[b, 1] = np.exp(getattr(p, f"null_{kind}"))
        inq[b, 1] = np.exp(p.null_q)
        for name, arr in arrs.items():
            arr[b, :k] = np.maximum(
                np.asarray(getattr(p, name), np.float64), NEG
            )
    eps = float(profiles[0].cfg.epsilon)
    return emis, qp, ine, inq, pack_trans(arrs), eps


# rows of the specials ring (VB enters the DP only through ring_cs)
S_N, S_J, S_C, S_E, S_R = range(5)


def _semiring(name: str):
    """(join, reduce over a dim, inclusive prefix scan along the last
    dim): max = Viterbi, logsumexp = forward (viterbi_pallas.py:165)."""
    if name == "max":
        return (torch.maximum, torch.amax,
                lambda x: torch.cummax(x, dim=-1).values)
    if name == "logsumexp":
        return (torch.logaddexp, torch.logsumexp,
                lambda x: torch.logcumsumexp(x, dim=-1))
    raise ValueError(f"unknown semiring {name!r}")


def scores_plain(
    blk: CudaBlock,
    eidx: torch.Tensor,  # [S, Lp, 5] int32 end-fragment indices
    seq_len: torch.Tensor,  # [S] int32
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    semiring: str = "max",
):
    """Plain torch version of the kernel: (alt [S, B], null [S, B]) f32.

    The recurrence of viterbi_pallas._kernel, batched over [S reads,
    B profiles, K nodes] with a Python loop over positions: a 5-slot
    lookback ring of the core in-flow (with B->entry folded in at write
    time), the N/J/C/R specials from each read's length, the D-chain as a
    telescoped prefix scan and the capture of alt = T and null = R at
    i == seq_len.  Under "max" the joins are maxima and the scan a
    cummax; under "logsumexp" they are logaddexp, logsumexp and
    logcumsumexp.  The NEG clamp of the D-chain is the same in both."""
    join, red, cum = _semiring(semiring)
    fm, fin, trans = blk
    B, _, K = fm.shape
    S = eidx.shape[0]
    dev = fm.device
    seq_len = seq_len.to(dev)
    eidx = eidx.to(dev).long()
    xt = specials(seq_len, multi_hits, hmmer3_compat)
    t_NN, t_NB, t_RR = (xt[k][:, None] for k in ("NN", "NB", "RR"))
    t_EJ, t_EC = xt["EJ"], xt["EC"]
    entry, mm_out, im_out, dm_out, mi, ii, a_base, cdd = trans.unbind(1)

    negk = torch.full((S, B, K), NEG, dtype=torch.float32, device=dev)
    neg1 = torch.full((S, B, 1), NEG, dtype=torch.float32, device=dev)
    # position 0: S -> B -> entry (VB[0] = t_NB), every other slot dead
    ring_cs = [t_NB[:, :, None] + entry] + [negk] * 4
    ring_ic = [negk] * 5
    ring_s = [torch.full((5, S, B), NEG, device=dev)] * 5
    alt = torch.full((S, B), NEG, dtype=torch.float32, device=dev)
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
        start5 = torch.where(lookback == i, 0.0, NEG)
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
    the CPU, the CUDA kernel of ``semiring`` for a block on the card."""
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    if not blk.fm.is_cuda:
        return scores_plain(
            blk, eidx, seq_len, multi_hits, hmmer3_compat, semiring
        )
    return _launch(blk, eidx, seq_len, multi_hits, hmmer3_compat, semiring)


def _launch(blk, eidx, seq_len, multi_hits, hmmer3_compat, semiring):
    from deciphon_tpu_torch.ops import _build

    fm, fin, trans = blk
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
    kernel = lib.dcp_viterbi_max if semiring == "max" else lib.dcp_viterbi_lse
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(
            fm.data_ptr(), fin.data_ptr(), trans.data_ptr(),
            eidx.data_ptr(), seq_len.data_ptr(), sp.data_ptr(),
            ctypes.c_float(xt["EJ"]), ctypes.c_float(xt["EC"]),
            alt.data_ptr(), null.data_ptr(), S, B, K, ntab, Lp, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"viterbi kernel ({semiring}) launch failed: "
            f"{_build.error_string(rc)}"
        )
    LAUNCHES[semiring] += 1
    return alt, null
