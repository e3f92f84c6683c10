"""Pass-2 traceback: backpointer Viterbi DP + host path walk.

The counterpart of deciphon_tpu/ops/viterbi_trace.py.  Only LRT
survivors reach it: one DP over a stack of (profile, read) hits with
per-position argmax codes, then an O(path) walk of the codes on the
host.  On the card the DP is one launch of the Hopper kernel
csrc/traceback.cu per chunk of at most TRACE_BATCH hits, a row and a
CTA or cluster each (``launch_trace``, the counterpart of the jitted
``_trace_scan_batch`` :266; its launch shape per width is
``trace_plan``'s); ``trace_dp`` is its plain torch version, which the
CPU runs.  A scan's pass 2 (``trace_scan``) queues every chunk of every
group before the host waits, once per QUEUE_BYTES of queued chunks;
``viterbi_alt`` traces one hit.  The entry points run on the card unless
given ``device="cpu"``, and raise without a GPU.

Pass 2 scores from the host's f64 fragment tables cast to f32
(ProteinProfile.fragment_tables, clamped to NEG): on the CPU from
``build_profile_block``; on a card the same f64 product, log, clamp and
cast run on the card (``card_tables``), from each hit's linear rows
uploaded in one copy a chunk (``table_rows``), so the host forms no
table.

Tie-breaking replicates the reference exactly: candidates flatten in
(fragment length ascending, origin ascending) order and the first maximum
wins (``torch.argmax`` returns the first index of the max); E takes every
M before any D, and D_0 never ends a path.  The D-chain clamps dead DD
links at NEG/1e6 as the reference's DP does (:63), so that paths are
identical, not merely equal in score.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from deciphon_tpu_torch.models import frame
from deciphon_tpu_torch.models import state as st
from deciphon_tpu_torch.models.frame import frag_layout
from deciphon_tpu_torch.ops import viterbi_ref as vr
from deciphon_tpu_torch.ops.emissions import fragment_indices
from deciphon_tpu_torch.ops.viterbi_torch import (
    NEG,
    TRANS_NAMES,
    ProfileBlock,
    build_profile_block,
    end_fragment_indices,
    resolve_device,
    specials,
    stack_transitions,
)
from deciphon_tpu_torch.utils import trace

# survivors per traceback DP: bounds the [L, H, K] backpointer tensors
TRACE_BATCH = 128
# the ten per-position outputs of the DP, in trace_dp's order
YS = ("bpM", "bpI", "dD", "bpE", "bpN", "bpJ", "bpC", "bpB", "bpT", "VT")
# planes of the kernel's [H, 9, K] tensor (csrc/traceback.cu P_*)
TRACE_PLANES = ("entry", "mm_in", "im_in", "dm_in", "mi", "ii", "md_next",
                "cdd_next", "cdd")
# launches of csrc/traceback.cu made by launch_trace (callers that must
# show a run went through the kernel set it to 0 before and read it after)
LAUNCHES = {"traceback": 0}
# pass 2's host waits for the card (trace_scan: one per window of
# QUEUE_BYTES, one per scan that fits)
HOST_WAITS = {"pass2": 0}
# dynamic shared memory a CTA may take (the card's 227 KB opt-in, less a
# margin)
SMEM_MAX = 232448 - 1024
# a scan's chunks in flight side by side: one stream each, reused in turn
STREAMS = 8
# device bytes of pass 2's queued chunks (inputs and outputs) before the
# host waits for them (trace_scan): one wait for a scan whose chunks fit
QUEUE_BYTES = 2 << 30
# device bytes of the f64 temporaries (and the f32 result) of one row
# slice of a chunk's fragment tables on a card (card_tables)
TABLE_SLICE_BYTES = 64 << 20
# read classes whose fragment tables come from the codon marginals
# (frame.fragment_table); the others' from the codon probabilities
# (frame.fragment_table_codes), as ProteinProfile.fragment_tables picks
MARG_CODES = ((), ("N",))


def _push(ring, new):
    return torch.cat([new[None], ring[:-1]], 0)


def _shift_k(a):  # along the node axis: a[..., k] -> a[..., k-1]
    return torch.cat([torch.full_like(a[..., :1], NEG), a[..., :-1]], -1)


def _t(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _upload(arrs: dict, eidx: np.ndarray, seq_len: np.ndarray,
            multi_hits: bool, hmmer3_compat: bool, dev: torch.device):
    """A chunk's tensors on ``dev`` for the DP, plain or kernel: the
    tables fm, fi and fn of ``arrs`` if it has them (a host block's,
    ``ProfileBlock._asdict()``), its transitions (TRANS_NAMES arrays
    [H, K]), eidx (int64), the specials and the D-chain's cdd, md_next
    and cdd_next, computed by the same torch calls for both versions (a
    cumsum on the card rounds as a parallel scan)."""
    d = {n: _t(arrs[n], dev) for n in ("fm", "fi", "fn", *TRANS_NAMES)
         if n in arrs}
    H = d["entry"].shape[0]
    xt = specials(_t(np.asarray(seq_len, np.int32), dev), multi_hits,
                  hmmer3_compat)
    d.update(NN=xt["NN"], NB=xt["NB"], EJ=xt["EJ"], EC=xt["EC"])
    dd_safe = torch.clamp_min(d["dd_in"], NEG / 1e6)
    dd_safe[:, 0] = 0.0
    d["cdd"] = torch.cumsum(dd_safe, 1)
    d["neg1"] = torch.full((H, 1), NEG, device=dev)
    d["md_next"] = torch.cat([d["md_in"][:, 1:], d["neg1"]], 1)
    d["cdd_next"] = torch.cat([d["cdd"][:, 1:], d["cdd"][:, -1:]], 1)
    d["eidx"] = _t(np.asarray(eidx, np.int64), dev)
    return d


def trace_dp(block: ProfileBlock, eidx: np.ndarray, seq_len: np.ndarray,
             multi_hits: bool, hmmer3_compat: bool, device="cpu"):
    """Backpointer Viterbi over H (profile, read) pairs: row h of
    ``block`` against read h, in plain torch on ``device`` (the kernel's
    plain version).  Returns (alt [H], ys) with ys numpy arrays indexed
    [position-1, h, ...]:
      bpM, bpI [L, H, K] flattened (l-1)*origins + origin
      dD [L, H, K] bool: the D-chain extends (origin D) vs enters from M
      bpE [L, H] in [0, 2K): < K -> M_k, else D_{k-K}
      bpN, bpJ, bpC [L, H] flattened (l-1)*2 + origin
      bpB [L, H] 0=S 1=N 2=E 3=J;  bpT [L, H] 0=E 1=C
    """
    dev = torch.device(device)
    d = _upload(block._asdict(), eidx, seq_len, multi_hits,
                hmmer3_compat, dev)
    fm, fi, fn = d["fm"], d["fi"], d["fn"]
    entry, mm_in, im_in, dm_in, mi, ii = (
        d[n] for n in ("entry", "mm_in", "im_in", "dm_in", "mi", "ii")
    )
    H, K, _ = fm.shape
    NN, NB, EJ, EC = d["NN"], d["NB"], d["EJ"], d["EC"]
    cdd, md_next, cdd_next, neg1 = (
        d[n] for n in ("cdd", "md_next", "cdd_next", "neg1")
    )
    node0 = torch.arange(K, device=dev) == 0

    neg_k = torch.full((5, H, K), NEG, device=dev)
    neg_5 = torch.full((5, H), NEG, device=dev)
    VM = VI = VD = neg_k
    VS = neg_5.clone()
    VS[0] = 0.0
    VN = VJ = VC = VE = neg_5
    VB = neg_5.clone()
    VB[0] = NB
    eidx_d = d["eidx"]
    Lmax = int(np.max(seq_len))
    outs = {k: [] for k in YS}
    for pos in range(Lmax):
        idx = eidx_d[:, pos]  # [H, 5]
        em_m = torch.gather(
            fm, 2, idx[:, None, :].expand(H, K, 5)
        ).permute(2, 0, 1)  # [5, H, K]
        em_i = torch.gather(fi, 1, idx).T  # [5, H]
        em_n = torch.gather(fn, 1, idx).T

        # match: candidates [5 lengths, 4 origins (B, M, I, D), H, K]
        candM = torch.stack(
            [
                VB[:, :, None] + entry,
                _shift_k(VM) + mm_in,
                _shift_k(VI) + im_in,
                _shift_k(VD) + dm_in,
            ],
            1,
        ) + em_m[:, None]
        flatM = candM.reshape(20, H, K)
        VMn, bpM = flatM.amax(0), torch.argmax(flatM, 0)
        # insert: [5, 2 origins (M, I), H, K]
        candI = torch.stack([VM + mi, VI + ii], 1) + em_i[:, None, :, None]
        flatI = candI.reshape(10, H, K)
        VIn, bpI = flatI.amax(0), torch.argmax(flatI, 0)
        # N / J / C loops: [5, 2 origins, H]
        candN = torch.stack([VS + NN, VN + NN], 1) + em_n[:, None]
        candJ = torch.stack([VE + EJ + NN, VJ + NN], 1) + em_n[:, None]
        candC = torch.stack([VE + EC + NN, VC + NN], 1) + em_n[:, None]
        bpN = torch.argmax(candN.reshape(10, H), 0)
        bpJ = torch.argmax(candJ.reshape(10, H), 0)
        bpC = torch.argmax(candC.reshape(10, H), 0)
        VNn = candN.reshape(10, H).amax(0)
        VJn = candJ.reshape(10, H).amax(0)
        VCn = candC.reshape(10, H).amax(0)

        # D-chain via prefix cummax; binary bp: direct M_{k-1} vs chain
        a = VMn + md_next - cdd_next
        b = torch.cummax(a, 1).values
        VDn = torch.clamp_min(cdd + torch.cat([neg1, b[:, :-1]], 1), NEG)
        a_prev = torch.cat([neg1, a[:, :-1]], 1)
        b_prev2 = torch.cat([neg1, neg1, b[:, :-2]], 1)[:, :K]
        dD = a_prev < b_prev2

        # E: all M before any D on ties; D_0 never ends a path
        flatE = torch.cat([VMn, torch.where(node0, NEG, VDn)], 1)
        VEn, bpE = flatE.amax(1), torch.argmax(flatE, 1)
        # S->B only at position 0 (carry init): the S slot stays dead so
        # bpB codes keep the reference's 0=S 1=N 2=E 3=J
        candB = torch.stack(
            [torch.full_like(VNn, NEG), VNn + NB, VEn + EJ + NB, VJn + NB]
        )
        VBn, bpB = candB.amax(0), torch.argmax(candB, 0)
        candT = torch.stack([VEn + EC + NB, VCn + NB])
        VT, bpT = candT.amax(0), torch.argmax(candT, 0)

        VM, VI, VD = _push(VM, VMn), _push(VI, VIn), _push(VD, VDn)
        VS = _push(VS, torch.full_like(VNn, NEG))
        VN, VJ, VC = _push(VN, VNn), _push(VJ, VJn), _push(VC, VCn)
        VE, VB = _push(VE, VEn), _push(VB, VBn)
        for k, v in (
            ("bpM", bpM.to(torch.int8)), ("bpI", bpI.to(torch.int8)),
            ("dD", dD), ("bpE", bpE.to(torch.int32)), ("bpN", bpN),
            ("bpJ", bpJ), ("bpC", bpC), ("bpB", bpB), ("bpT", bpT),
            ("VT", VT),
        ):
            outs[k].append(v)
    ys = {k: torch.stack(v).cpu().numpy() for k, v in outs.items()}
    alt = ys["VT"][np.asarray(seq_len) - 1, np.arange(H)]
    return alt, ys


# The plan table: (widest K, plan kind, nodes a thread), the card's best
# of chip_smoke.py --trace-sweep
TRACE_TABLE = (
    (512, "cta", 1),  # a CTA per hit
    (1024, "cta", 2),
    (1792, "cluster", 2),  # a cluster of CTAs per hit: 2, then 4 at K 2049
    (2048, "cluster", 4),
    (4096, "cluster", 2),
)
TRACE_KINDS = ("cta", "cluster")
# the kernel's instantiations (csrc/traceback.cu DCP_TRACE_KERNELS): the
# table's (kind, nodes a thread)
TRACE_KERNELS = tuple(dict.fromkeys((k, n) for _, k, n in TRACE_TABLE))
MAX_K = TRACE_TABLE[-1][0]
CTA_THREADS = 512  # threads per CTA of a CTA or cluster plan, at most
MAX_CLUSTER = 4  # CTAs per hit of a cluster plan, at most
# the cross-warp tables of the CTA and cluster plans: 5 floats per warp of
# a hit, for MAX_CLUSTER x 16 warps
TABLE_BYTES = 4 * 5 * MAX_CLUSTER * CTA_THREADS // 32


class TracePlan(NamedTuple):
    """Launch shape of the traceback kernel for width K."""

    kind: str  # "cta" or "cluster" (TRACE_KINDS)
    npt: int  # consecutive nodes a thread
    warps: int  # warps of a hit in each of its CTAs
    cluster: int  # CTAs per hit
    threads: int  # threads per CTA
    smem: int  # dynamic shared bytes per CTA: rings and tables


def _rings(threads: int, npt: int) -> int:
    """Bytes of one hit's (one CTA's share) M, I, D rings: [3][5][RS],
    a column per node of the threads and the sentinel column."""
    return 4 * 15 * (threads * npt + 1)


def _plan(kind: str, npt: int, K: int) -> TracePlan:
    """The launch shape of plan ``kind`` at ``npt`` nodes a thread for
    width K: a CTA plan as many whole warps as K needs; a cluster plan
    the fewest CTAs (2 or 4) that hold K at CTA_THREADS threads each, and
    as many warps in each as its share of the nodes needs.  Raises if no
    instantiation takes it."""
    C = 1
    if kind == "cluster":
        C = 2
        while C * CTA_THREADS * npt < K and C < MAX_CLUSTER:
            C *= 2
    warps = -(-(-(-K // C)) // (32 * npt))
    plan = TracePlan(kind, npt, warps, C, 32 * warps,
                     _rings(32 * warps, npt) + TABLE_BYTES)
    if (kind, npt) not in TRACE_KERNELS:
        raise ValueError(f"K={K}: no instantiation for {plan}")
    if (plan.smem > SMEM_MAX or plan.threads > CTA_THREADS
            or plan.threads * plan.npt * plan.cluster < K):
        raise ValueError(f"K={K}: {plan} does not fit")
    return plan


def trace_plan(K: int) -> TracePlan:
    """The traceback kernel's launch shape for width K (1..MAX_K), from
    TRACE_TABLE.  A position's time grows with the nodes a thread holds,
    so the table spreads a hit over as many threads as its width fills."""
    if not 0 < K <= MAX_K:
        raise ValueError(f"K={K}: need 1..{MAX_K}")
    _, kind, npt = next(row for row in TRACE_TABLE if K <= row[0])
    return _plan(kind, npt, K)


class TracePack(NamedTuple):
    """A chunk in the kernel's layout, on its device."""

    fmT: torch.Tensor  # [H, ntab, K] f32, rows contiguous along K
    fin: torch.Tensor  # [H, 2, ntab] f32: fi, fn
    planes: torch.Tensor  # [H, 9, K] f32, TRACE_PLANES
    eidx: torch.Tensor  # [H, Lmax, 5] int32
    sp: torch.Tensor  # [H, 2] f32: NN, NB
    EJ: float
    EC: float


def pack_chunk(profs: list, eidx: np.ndarray, seq_len: np.ndarray,
               kpad: int | None, codes: tuple | None, multi_hits: bool,
               hmmer3_compat: bool, device, stream=None) -> TracePack:
    """The kernel's inputs for a chunk of hits (one profile a hit) at
    width ``kpad`` (the widest core if None): the fragment tables
    computed on ``device`` by ``card_tables`` from the rows of
    ``table_rows``, uploaded in one copy (from pinned memory on a card),
    the match tables laid out so that a fragment row is contiguous along
    the nodes; trace_dp's other uploaded tensors (``_upload``), the
    planes stacked, eidx cut to the chunk's Lmax rows.  On a card,
    ``stream`` (if given) runs the tables' work after the uploads.
    Counts the chunk's hits in the scan's counter ``trace_tables``."""
    dev = torch.device(device)
    codes = tuple(codes or ())
    K = kpad if kpad is not None else max(p.core_size for p in profs)
    rows = table_rows(profs, codes, K, pin=dev.type == "cuda").to(
        dev, non_blocking=True)
    d = _upload(stack_transitions(profs, K), eidx, seq_len, multi_hits,
                hmmer3_compat, dev)
    ctx = contextlib.nullcontext()
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(dev))
        rows.record_stream(stream)  # freed only after the tables' work
        ctx = torch.cuda.stream(stream)
    with ctx:
        fmT, fin = card_tables(rows, [p.core_size for p in profs],
                               [p.cfg.epsilon for p in profs], K, codes)
    trace.count("trace_tables", len(profs))
    Lmax = int(np.max(seq_len)) if len(seq_len) else 0
    return TracePack(
        fmT=fmT, fin=fin,
        planes=torch.stack([d[n] for n in TRACE_PLANES], 1).contiguous(),
        eidx=d["eidx"][:, :Lmax].to(torch.int32).contiguous(),
        sp=torch.stack([d["NN"], d["NB"]], 1).contiguous(),
        EJ=float(d["EJ"]), EC=float(d["EC"]),
    )


def _ntab(codes: tuple | None) -> int:
    """Fragment rows of a table of read class ``codes``, the sentinel's
    too."""
    return frag_layout(4 + len(codes or ()))[1] + 1


def _row_width(codes: tuple) -> tuple[int, int]:
    """(W, S) of a table row of read class ``codes``: its linear pattern
    marginals and background masses, as frame.fragment_table (codes ()
    and ("N",)) or frame.fragment_table_codes forms them."""
    if codes in MARG_CODES:
        return 125, 5
    S = 5 + len(codes)
    return S**3, S


def _linear(p, part: str, codes: tuple) -> np.ndarray:
    """[..., W + S] f64: the linear pattern marginals and masses of the
    ``part`` ("match", "insert" or "null") rows of profile ``p``, by the
    host tables' own calls on its log rows."""
    q = getattr(p, f"{part}_q")
    if codes in MARG_CODES:
        return np.concatenate([np.exp(getattr(p, f"{part}_marg")),
                               np.exp(q)], -1)
    return np.concatenate([
        np.exp(getattr(p, f"{part}_codonp")) @ frame.ext_agg(codes).T,
        frame.ext_q(q, codes)], -1)


def table_rows(profs: list, codes: tuple, K: int,
               pin: bool = False) -> torch.Tensor:
    """A chunk's table inputs in one host buffer of bytes (pinned if
    ``pin``), as ``card_tables`` reads it: rows [R, W + S] f64
    (``_row_width``), R = the hits' cores then two a hit, each hit's
    insert and null rows, each row the linear inputs of its fragment
    table (``_linear``: what ProteinProfile.fragment_tables forms from
    the profile's log rows); then each match row's place h * K + k in
    the chunk, int64."""
    W, S = _row_width(codes)
    cores = [p.core_size for p in profs]
    Rm = sum(cores)
    R = Rm + 2 * len(profs)
    nrow = 8 * R * (W + S)
    buf = torch.empty(nrow + 8 * Rm, dtype=torch.uint8, pin_memory=pin)
    raw = buf.numpy()
    rows = raw[:nrow].view(np.float64).reshape(R, W + S)
    where = raw[nrow:].view(np.int64)
    r = 0
    for h, p in enumerate(profs):
        rows[r:r + p.core_size] = _linear(p, "match", codes)
        where[r:r + p.core_size] = h * K + np.arange(p.core_size)
        r += p.core_size
        rows[Rm + 2 * h] = _linear(p, "insert", codes)
        rows[Rm + 2 * h + 1] = _linear(p, "null", codes)
    return buf


@functools.cache
def fragment_coefs(eps: float, codes: tuple, device) -> torch.Tensor:
    """frame.fragment_matrix at base 4 or 5, the f64 coefficient matrix
    of read class () or ("N",) (MARG_CODES), on ``device`` (a
    torch.device with its index), uploaded once and kept: 34 and 98 MB
    an epsilon."""
    return torch.as_tensor(frame.fragment_matrix(eps, 4 + len(codes)),
                           device=device)


def _col_step(codes: tuple) -> int:
    """Columns of one slice of the coefficient matrix of read class
    ``codes`` on the card: all of them for MARG_CODES, whose matrices
    are kept; else as many as TABLE_SLICE_BYTES holds."""
    W, S = _row_width(codes)
    if codes in MARG_CODES:
        return _ntab(codes)
    return max(1, min(_ntab(codes), TABLE_SLICE_BYTES // (8 * S * S * W)))


@functools.cache
def _host_slices(eps: float, codes: tuple, step: int) -> tuple:
    """The host's frame.ext_fragment_matrix of read class ``codes`` cut
    into contiguous slices of ``step`` columns, (first column, end
    column, array) each, made once and kept beside frame's own copy, so
    that each chunk uploads them with plain copies."""
    C = frame.ext_fragment_matrix(eps, codes)
    return tuple((c0, min(c0 + step, C.shape[1]),
                  np.ascontiguousarray(C[:, c0:c0 + step]))
                 for c0 in range(0, C.shape[1], step))


def _coef_slices(eps: float, codes: tuple, dev: torch.device):
    """(first column, end column, C[:, first:end] on ``dev``) of the f64
    coefficient matrix of read class ``codes``: for MARG_CODES one
    slice, the kept matrix of ``fragment_coefs``; for other code sets
    (1.25 GB for two codes, 5.1 GB for three, more for each code after)
    the host's slices (``_host_slices``, ``_col_step`` columns each)
    uploaded one at a time, on the current stream, each dropped after
    its use, so that the card holds at most two slices of it for any
    code set."""
    if codes in MARG_CODES:
        C = fragment_coefs(eps, codes, dev)
        yield 0, C.shape[1], C
        return
    for c0, c1, part in _host_slices(eps, codes, _col_step(codes)):
        yield c0, c1, torch.from_numpy(part).to(dev)


@functools.cache
def _tables_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream of pass 2's tables on card ``dev``, one a process:
    cuBLAS keeps a workspace for every stream its products run on."""
    return torch.cuda.Stream(dev)


def _coef_bytes(codes: tuple) -> int:
    """Device bytes of read class ``codes``' coefficient matrix while
    ``card_tables`` runs: the kept matrix for MARG_CODES, two column
    slices (``_coef_slices``) for other code sets."""
    W, S = _row_width(codes)
    if codes in MARG_CODES:
        return 8 * S * S * W * _ntab(codes)
    return 2 * 8 * S * S * W * _col_step(codes)


def _slice_rows(codes: tuple) -> int:
    """Rows of one slice of ``card_tables`` within TABLE_SLICE_BYTES: a
    row's pair products, products with its marginals and probabilities
    over a column slice (``_col_step``), f64, and its f32 result."""
    W, S = _row_width(codes)
    cols = _col_step(codes)
    return max(1, TABLE_SLICE_BYTES // (8 * (S * S + S * S * W + cols)
                                        + 4 * cols))


def card_tables(rows: torch.Tensor, cores: list, eps: list, K: int,
                codes: tuple):
    """(fmT [H, ntab, K], fin [H, 2, ntab]) f32 of a chunk on the device
    of ``rows`` (``table_rows``' buffer there): per row, the products of
    its masses' pairs with its pattern marginals times the f64
    coefficient matrix of its profile's epsilon, a column slice at a
    time (``_coef_slices``), its log, the sentinel column -inf, clamped
    to NEG and cast to f32, frame.fragment_table's order of operations
    and build_profile_block's clamp; a match row written to its node's
    column of fmT, the nodes past a core NEG, as build_profile_block pads
    them.  Rows go in slices of ``_slice_rows``."""
    W, S = _row_width(codes)
    ntab = _ntab(codes)
    H, Rm = len(cores), sum(cores)
    R = Rm + 2 * H
    nrow = 8 * R * (W + S)
    x = rows[:nrow].view(torch.float64).view(R, W + S)
    where = rows[nrow:].view(torch.int64)
    dev = rows.device
    fmT = torch.full((H, ntab, K), NEG, dtype=torch.float32, device=dev)
    fin = torch.empty((H, 2, ntab), dtype=torch.float32, device=dev)
    fin_rows = fin.view(2 * H, ntab)
    step = _slice_rows(codes)
    start = np.concatenate([[0], np.cumsum(cores)]).astype(int)
    h = 0
    for e, run in itertools.groupby(eps):  # a run of hits of one epsilon
        a, h = h, h + len(list(run))
        for c0, c1, C in _coef_slices(float(e), codes, dev):
            for lo, hi, match in ((start[a], start[h], True),
                                  (Rm + 2 * a, Rm + 2 * h, False)):
                for r0 in range(lo, hi, step):
                    r1 = min(r0 + step, hi)
                    q = x[r0:r1, W:]
                    qq = (q[:, :, None] * q[:, None, :]).reshape(
                        r1 - r0, S * S)
                    D = (qq[:, :, None] * x[r0:r1, None, :W]).reshape(
                        r1 - r0, S * S * W)
                    lp = (D @ C).log_()
                    if c1 == ntab:
                        lp[:, -1] = -np.inf
                    tab = lp.clamp_min_(NEG).to(torch.float32)
                    if match:
                        at = where[r0:r1]
                        fmT[at // K, c0:c1, at % K] = tab
                    else:
                        fin_rows[r0 - Rm:r1 - Rm, c0:c1] = tab
    return fmT, fin


class TraceOut(NamedTuple):
    """The kernel's outputs in one device buffer (of one chunk, or a
    chunk's share of a scan's buffer), copied to the host in one
    transfer."""

    buf: torch.Tensor  # uint8
    views: dict  # name -> (offset, numpy dtype, shape)

    def host(self, raw: np.ndarray | None = None) -> dict:
        """ys as numpy arrays, as trace_dp returns them: views of ``raw``,
        the buffer already on the host, or of a copy made now."""
        if raw is None:
            raw = self.buf.cpu().numpy()
        return {
            k: raw[off:off + int(np.prod(shape)) * np.dtype(dt).itemsize]
            .view(dt).reshape(shape)
            for k, (off, dt, shape) in self.views.items()
        }


def _layout(L: int, H: int, K: int, base: int = 0) -> tuple[dict, int]:
    """(name -> (byte offset, numpy dtype, shape), end offset) of a
    chunk's outputs in a buffer, from byte ``base``: the YS arrays in
    trace_dp's shapes, each 16-aligned."""
    views, off = {}, base
    for k in YS:
        if k in ("bpM", "bpI", "dD"):
            dt, shape = (np.bool_ if k == "dD" else np.int8), (L, H, K)
        else:
            dt, shape = (np.float32 if k == "VT" else np.int32), (L, H)
        views[k] = (off, dt, shape)
        off += -(-int(np.prod(shape)) * np.dtype(dt).itemsize // 16) * 16
    return views, off


def launch_trace(pk: TracePack, out: TraceOut | None = None) -> TraceOut:
    """One launch of csrc/traceback.cu over the chunk ``pk`` on its
    device and the current stream, into ``out`` (a new buffer if None),
    under ``trace_plan(K)``; no fallback: a failed build or launch, or a
    refused cluster, raises."""
    return _launch(pk, out, trace_plan(pk.fmT.shape[2]))


def _launch(pk: TracePack, out: TraceOut | None,
            plan: TracePlan) -> TraceOut:
    """``launch_trace`` under ``plan`` (chip_smoke.py --trace-sweep times
    the alternatives of ``_plan``)."""
    from deciphon_tpu_torch.ops import _build

    dev = pk.fmT.device
    if dev.type != "cuda":
        raise ValueError(f"the traceback kernel runs on a card, not {dev} "
                         "(trace_dp is the plain version)")
    lib = _build.library()
    H, ntab, K = pk.fmT.shape
    Lmax = pk.eidx.shape[1]
    for name, t, dt, shape in (
        ("fmT", pk.fmT, torch.float32, (H, ntab, K)),
        ("fin", pk.fin, torch.float32, (H, 2, ntab)),
        ("planes", pk.planes, torch.float32, (H, len(TRACE_PLANES), K)),
        ("eidx", pk.eidx, torch.int32, (H, Lmax, 5)),
        ("sp", pk.sp, torch.float32, (H, 2)),
    ):
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name}: need a contiguous {dt} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if out is None:
        views, nbytes = _layout(Lmax, H, K)
        out = TraceOut(torch.empty(nbytes, dtype=torch.uint8, device=dev),
                       views)
    elif out.buf.device != dev or out.views["bpM"][2] != (Lmax, H, K):
        raise ValueError(f"output buffer on {out.buf.device} for "
                         f"{out.views['bpM'][2]}, chunk ({Lmax}, {H}, {K}) "
                         f"on {dev}")
    if H == 0 or Lmax == 0:
        return out

    def ptr(k):
        return out.buf.data_ptr() + out.views[k][0]
    with torch.cuda.device(dev):
        rc = lib.dcp_traceback(
            pk.fmT.data_ptr(), pk.fin.data_ptr(), pk.planes.data_ptr(),
            pk.eidx.data_ptr(), pk.sp.data_ptr(), ctypes.c_float(pk.EJ),
            ctypes.c_float(pk.EC), *(ptr(k) for k in YS), H, K, ntab, Lmax,
            TRACE_KINDS.index(plan.kind), plan.npt, plan.warps, plan.cluster,
            plan.threads, plan.smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"traceback kernel launch failed ({plan}): "
                           f"{_build.error_string(rc)}")
    LAUNCHES["traceback"] += 1
    trace.count("launch.traceback")
    return out


def walk(ys, L: int, K: int) -> list[tuple[int, int]]:
    """Host walk of one hit's backpointer codes (arrays indexed
    [position-1, ...]) -> imm-style step list (reference _walk :198)."""
    bpM, bpI, dD, bpE = ys["bpM"], ys["bpI"], ys["dD"], ys["bpE"]
    bpN, bpJ, bpC, bpB, bpT = (
        ys["bpN"], ys["bpJ"], ys["bpC"], ys["bpB"], ys["bpT"]
    )
    path: list[tuple[int, int]] = [(st.T, 0)]
    i = L  # positions are 1-based; codes index i-1
    cur = ("E", 0) if bpT[L - 1] == 0 else ("C", 0)
    # worst legal path: ~L hits, each through an O(K) delete chain
    guard = L * (K + 8) + 16
    while guard > 0:
        guard -= 1
        kind, k = cur
        if kind == "E":
            path.append((st.E, 0))
            e = int(bpE[i - 1])
            cur = ("M", e) if e < K else ("D", e - K)
        elif kind in ("C", "J", "N"):
            bp = {"C": bpC, "J": bpJ, "N": bpN}[kind][i - 1]
            o, l = int(bp) % 2, int(bp) // 2 + 1
            path.append(({"C": st.C, "J": st.J, "N": st.N}[kind], l))
            i -= l
            nxt = {"C": ("E", "C"), "J": ("E", "J"), "N": ("S", "N")}[kind]
            cur = (nxt[0] if o == 0 else nxt[1], 0)
        elif kind == "B":
            path.append((st.B, 0))
            if i == 0:
                cur = ("S", 0)
            else:
                cur = (("S", "N", "E", "J")[int(bpB[i - 1])], 0)
        elif kind == "M":
            code = int(bpM[i - 1, k])
            l, o = code // 4 + 1, code % 4
            path.append((st.match_id(k), l))
            i -= l
            cur = (("B", "M", "I", "D")[o], 0 if o == 0 else k - 1)
        elif kind == "I":
            code = int(bpI[i - 1, k])
            l, o = code // 2 + 1, code % 2
            path.append((st.insert_id(k), l))
            i -= l
            cur = ("M", k) if o == 0 else ("I", k)
        elif kind == "D":
            path.append((st.delete_id(k), 0))
            cur = ("D", k - 1) if dD[i - 1, k] else ("M", k - 1)
        elif kind == "S":
            path.append((st.S, 0))
            break
    else:
        raise RuntimeError("traceback walk did not terminate")
    path.reverse()
    return path


def chunks(profs: list, seqs: list[np.ndarray], kpad: int | None = None,
           codes: tuple | None = None):
    """(block, eidx, lens) per chunk of ``chunk_reads``: the host block of
    the chunk's real hits, one row each."""
    for chunk_p, eidx, lens in chunk_reads(profs, seqs, codes):
        yield build_profile_block(chunk_p, kpad=kpad, codes=codes), eidx, lens


def chunk_reads(profs: list, seqs: list[np.ndarray],
                codes: tuple | None = None):
    """(profiles, eidx, lens) per chunk of at most TRACE_BATCH hits: the
    chunk's real hits, one row each (the card runs a CTA or a cluster per
    hit, so the hit axis has no shape to fill), and their reads' eidx
    and lengths."""
    base = 4 + len(codes) if codes else 4
    for lo in range(0, len(profs), TRACE_BATCH):
        chunk_s = seqs[lo : lo + TRACE_BATCH]
        Lp = max(len(s) for s in chunk_s)
        eidx = np.stack([
            end_fragment_indices(
                fragment_indices(s, pad_to=Lp, base=base), base=base
            )
            for s in chunk_s
        ])
        lens = np.array([len(s) for s in chunk_s], np.int32)
        yield profs[lo : lo + TRACE_BATCH], eidx, lens


def chunk_shapes(profs: list, seqs: list, kpad: int | None = None,
                 codes: tuple | None = None):
    """(H, Lmax, K, ntab) of each chunk of ``chunks``, known before any
    block is built."""
    ntab = _ntab(codes)
    for lo in range(0, len(profs), TRACE_BATCH):
        chunk_p = profs[lo : lo + TRACE_BATCH]
        Lmax = max(len(s) for s in seqs[lo : lo + TRACE_BATCH])
        K = kpad if kpad is not None else max(p.core_size for p in chunk_p)
        yield len(chunk_p), Lmax, K, ntab


def viterbi_alt_batch(
    profs: list,
    seqs: list[np.ndarray],
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    kpad: int | None = None,
    device="cuda",
    codes: tuple | None = None,
) -> list[vr.ViterbiResult]:
    """Traceback of a stack of (profile, encoded read) hits, one DP per
    chunk of ``chunks`` (at most TRACE_BATCH hits, a row each): the
    kernel on a card, ``trace_dp`` on the CPU; walks stay per hit
    (``trace_scan`` of one group).  Reads holding the IUPAC ``codes``
    (encoded 4+j, alphabet.encode_extended) run on the extended
    base-(4+D) tables.  The DP is Viterbi under either scan
    semiring: a forward scan's hits still decode their best path."""
    return trace_scan([(profs, seqs, kpad, codes)], multi_hits,
                      hmmer3_compat, device)[0]


def viterbi_alt(
    prof,
    seq_idx: np.ndarray,
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    block_row: ProfileBlock | None = None,
    pad_to: int | None = None,
    base: int = 4,
    codes: tuple | None = None,
    device="cuda",
) -> vr.ViterbiResult:
    """Traceback of one (profile, encoded read) hit, the counterpart of
    the JAX package's ``viterbi_alt`` (viterbi_trace.py:333):
    ``trace_scan`` of one group holding one hit.  ``block_row``, the
    profile's one-row ProfileBlock if already built, gives the padded
    width (its tables are built anew, of ``codes``); ``base=5`` is
    ``codes=("N",)``.  ``pad_to`` pads the read's index rows in the JAX
    package; the DP stops before them, so here it changes nothing."""
    if codes is None and base not in (4, 5):
        raise ValueError(f"base {base}: need 4, 5 or codes")
    if codes is None and base == 5:
        codes = ("N",)
    kpad = None if block_row is None else block_row.fm.shape[1]
    return trace_scan([([prof], [seq_idx], kpad, codes)], multi_hits,
                      hmmer3_compat, device)[0][0]


def _on_card(dev: torch.device) -> bool:
    """Whether pass 2 runs the kernel on ``dev`` (else trace_dp)."""
    return dev.type == "cuda"


def _chunk_bytes(H: int, L: int, K: int, ntab: int) -> int:
    """Device bytes a queued chunk holds until its launch ends: its
    packed inputs (``TracePack``) and its share of the output buffer."""
    inputs = 4 * H * (ntab * K + 2 * ntab + len(TRACE_PLANES) * K
                      + 5 * L + 2)
    return inputs + _layout(L, H, K)[1]


def _rows_bytes(profs: list, codes: tuple | None) -> int:
    """Device bytes of a chunk's ``table_rows`` buffer on a card."""
    W, S = _row_width(tuple(codes or ()))
    nodes = sum(p.core_size for p in profs)
    return 8 * ((nodes + 2 * len(profs)) * (W + S) + nodes)


def _windows(groups: list, card: bool = False) -> list[list]:
    """The chunks of ``groups`` in queue order, cut into windows of at
    most QUEUE_BYTES (``_chunk_bytes``, and on a ``card`` the chunk's
    ``table_rows`` and, once a window, a row slice of ``card_tables`` and
    the coefficient matrices of the groups' read classes as they stand
    on the card, ``_coef_bytes``; a larger chunk is a window of its own): per window its chunks' (group, hits, output
    views), laid out from byte 0 of the output buffer, and the window's
    end byte."""
    windows, held = [], 0
    fixed = TABLE_SLICE_BYTES + sum(_coef_bytes(c) for c in {
        tuple(g[3] or ()) for g in groups}) if card else 0
    for g, (profs, seqs, kpad, codes) in enumerate(groups):
        for lo, (H, L, K, ntab) in zip(
                range(0, len(profs), TRACE_BATCH),
                chunk_shapes(profs, seqs, kpad, codes)):
            size = _chunk_bytes(H, L, K, ntab)
            if card:
                size += _rows_bytes(profs[lo : lo + TRACE_BATCH], codes)
            if not windows or held + size > QUEUE_BYTES:
                windows.append([[], 0])
                held = fixed
            views, windows[-1][1] = _layout(L, H, K, windows[-1][1])
            windows[-1][0].append((g, H, views))
            held += size
    return windows


def _to_host(buf: torch.Tensor, end: int, streams: list) -> np.ndarray:
    """The host wait of a window: the current stream joins the launch
    streams, then the outputs' first ``end`` bytes come back in one
    copy (counted in HOST_WAITS)."""
    if streams:
        main = torch.cuda.current_stream(buf.device)
        for s in streams:
            main.wait_stream(s)
    HOST_WAITS["pass2"] += 1
    trace.count("wait.pass2")
    return buf[:end].cpu().numpy()


def trace_scan(groups: list, multi_hits: bool = True,
               hmmer3_compat: bool = False,
               device="cuda") -> list[list[vr.ViterbiResult]]:
    """Pass 2 of a scan: for each group of ``groups``, (profiles, encoded
    reads, kpad, codes), the traceback of its (profile, read) hits, one
    DP per chunk of ``chunk_reads`` and a walk per hit, with one host
    wait per window of QUEUE_BYTES (``_windows``): one for a scan whose
    chunks fit in it.

    Every chunk of a window writes into its slice of one output buffer,
    laid out before the first chunk is packed and reused by the next
    window.  On a card each chunk is packed by ``pack_chunk``: its
    inputs are uploaded on the current stream, whose copies wait for
    nothing but that stream's own uploads, and its fragment tables are
    computed on the card on the tables' stream (``_tables_stream``), in
    chunk order; the chunk is launched on a stream of its own (STREAMS,
    reused in turn) once its uploads and tables are done, so the
    launches run side by side and the host packs the next chunk while
    the queued work runs; one device-to-host copy after the window's
    last launch (``_to_host``) is its only wait for the card.  On the
    CPU each chunk is ``trace_dp``'s on the host block of ``chunks``,
    written into the same layout.  The window's walks follow, hit by
    hit."""
    dev = resolve_device(device)
    card = _on_card(dev)
    if card:
        from deciphon_tpu_torch.ops import _build

        _build.library()  # a missing compiler raises before any upload
    windows = _windows(groups, card)
    results: list[list[vr.ViterbiResult]] = [[] for _ in groups]
    if not windows:
        return results
    buf = torch.empty(max(end for _, end in windows), dtype=torch.uint8,
                      device=dev)
    streams, tables = [], None
    if dev.type == "cuda":
        main = torch.cuda.current_stream(dev)
        streams = [torch.cuda.Stream(dev) for _ in range(
            min(STREAMS, max(len(w) for w, _ in windows)))]
        tables = _tables_stream(dev)
    chunk_iter = (c for profs, seqs, kpad, codes in groups
                  for c in (chunk_reads(profs, seqs, codes) if card
                            else chunks(profs, seqs, kpad, codes)))
    j = 0
    for window, end in windows:
        walks = []  # (read lengths, K) per chunk
        for g, H, views in window:
            with trace.span("pass2.pack"):  # the chunk's block or pack
                if card:
                    chunk_p, eidx, lens = next(chunk_iter)
                    pk = pack_chunk(chunk_p, eidx, lens, groups[g][2],
                                    groups[g][3], multi_hits, hmmer3_compat,
                                    dev, tables)
                    K = pk.fmT.shape[2]
                else:
                    block, eidx, lens = next(chunk_iter)
                    K = block.fm.shape[1]
            if views["bpM"][2] != (int(lens.max()), len(lens), K):
                raise AssertionError(f"chunk {j}: layout {views['bpM'][2]}")
            if card:
                ctx = contextlib.nullcontext()
                if streams:
                    s = streams[j % len(streams)]
                    s.wait_stream(main)  # the uploads, and the last copy
                    s.wait_stream(tables)  # the chunk's tables
                    for x in pk[:5]:  # freed only after the launch on s
                        x.record_stream(s)
                    ctx = torch.cuda.stream(s)
                with ctx:
                    launch_trace(pk, TraceOut(buf, views))
            else:
                _, ys = trace_dp(block, eidx, lens, multi_hits,
                                 hmmer3_compat, dev)
                raw = buf.numpy()
                for k, (off, dt, shape) in views.items():
                    b = np.ascontiguousarray(ys[k], dtype=dt).view(np.uint8)
                    raw[off:off + b.size] = b.ravel()
            walks.append((lens, K))
            j += 1
        with trace.span("pass2.wait"):
            raw = _to_host(buf, end, streams)  # the window's one wait
        with trace.span("pass2.walk"):
            for (g, H, views), (lens, K) in zip(window, walks):
                ys = TraceOut(buf, views).host(raw)
                for h in range(H):
                    ys_h = {k: v[:, h] for k, v in ys.items()}
                    results[g].append(vr.ViterbiResult(
                        float(ys["VT"][lens[h] - 1, h]),
                        walk(ys_h, int(lens[h]), K)))
    return results
