"""Pass-2 traceback: backpointer Viterbi DP in torch + host path walk.

The counterpart of deciphon_tpu/ops/viterbi_trace.py.  Only LRT
survivors reach it, so it is plain torch on the engine's device (the
reference runs it as ``lax.scan``, not Pallas): one DP over a stack of
(profile, read) hits with per-position argmax codes, then an O(path) walk
of the codes on the host.

Tie-breaking replicates the reference exactly: candidates flatten in
(fragment length ascending, origin ascending) order and the first maximum
wins (``torch.argmax`` returns the first index of the max); E takes every
M before any D, and D_0 never ends a path.  The D-chain clamps dead DD
links at NEG/1e6 as the reference's DP does (:63), so that paths are
identical, not merely equal in score.
"""

from __future__ import annotations

import numpy as np
import torch

from deciphon_tpu.models import state as st
from deciphon_tpu.ops import viterbi_ref as vr
from deciphon_tpu.ops.emissions import fragment_indices
from deciphon_tpu_torch.ops.viterbi_torch import (
    NEG,
    ProfileBlock,
    build_profile_block,
    end_fragment_indices,
    specials,
)

# survivors per traceback DP: bounds the [L, H, K] backpointer tensors
TRACE_BATCH = 128


def _push(ring, new):
    return torch.cat([new[None], ring[:-1]], 0)


def _shift_k(a):  # along the node axis: a[..., k] -> a[..., k-1]
    return torch.cat([torch.full_like(a[..., :1], NEG), a[..., :-1]], -1)


def trace_dp(block: ProfileBlock, eidx: np.ndarray, seq_len: np.ndarray,
             multi_hits: bool, hmmer3_compat: bool, device="cpu"):
    """Backpointer Viterbi over H (profile, read) pairs: row h of
    ``block`` against read h.  Returns (alt [H], ys) with ys numpy
    arrays indexed [position-1, h, ...]:
      bpM, bpI [L, H, K] flattened (l-1)*origins + origin
      dD [L, H, K] bool: the D-chain extends (origin D) vs enters from M
      bpE [L, H] in [0, 2K): < K -> M_k, else D_{k-K}
      bpN, bpJ, bpC [L, H] flattened (l-1)*2 + origin
      bpB [L, H] 0=S 1=N 2=E 3=J;  bpT [L, H] 0=E 1=C
    """
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fm, fi, fn = t(block.fm), t(block.fi), t(block.fn)
    entry, mm_in, im_in, dm_in, md_in, dd_in, mi, ii = (
        t(getattr(block, n)) for n in (
            "entry", "mm_in", "im_in", "dm_in", "md_in", "dd_in", "mi", "ii"
        )
    )
    H, K, _ = fm.shape
    slen = t(np.asarray(seq_len, np.int32))
    xt = specials(slen, multi_hits, hmmer3_compat)
    NN, NB, RR = xt["NN"], xt["NB"], xt["RR"]
    EJ, EC = xt["EJ"], xt["EC"]

    dd_safe = torch.clamp_min(dd_in, NEG / 1e6)
    dd_safe[:, 0] = 0.0
    cdd = torch.cumsum(dd_safe, 1)
    neg1 = torch.full((H, 1), NEG, device=dev)
    md_next = torch.cat([md_in[:, 1:], neg1], 1)
    cdd_next = torch.cat([cdd[:, 1:], cdd[:, -1:]], 1)
    node0 = torch.arange(K, device=dev) == 0

    neg_k = torch.full((5, H, K), NEG, device=dev)
    neg_5 = torch.full((5, H), NEG, device=dev)
    VM = VI = VD = neg_k
    VS = neg_5.clone()
    VS[0] = 0.0
    VN = VJ = VC = VE = VR = neg_5
    VB = neg_5.clone()
    VB[0] = NB
    eidx_d = t(np.asarray(eidx, np.int64))
    Lmax = int(np.max(seq_len))
    outs = {k: [] for k in (
        "bpM", "bpI", "dD", "bpE", "bpN", "bpJ", "bpC", "bpB", "bpT", "VT"
    )}
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
        # null-model R loop: [5] candidates in l order
        VRn = (torch.maximum(VR + RR, VS) + em_n).amax(0)

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
        VE, VB, VR = _push(VE, VEn), _push(VB, VBn), _push(VR, VRn)
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


def viterbi_alt_batch(
    profs: list,
    seqs: list[np.ndarray],
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    kpad: int | None = None,
    device="cpu",
    codes: tuple | None = None,
) -> list[vr.ViterbiResult]:
    """Traceback of a stack of (profile, encoded read) hits, TRACE_BATCH
    at a time with the hit axis padded to a power of two (the reference's
    viterbi_alt_batch :281); walks stay per hit.  Reads holding the IUPAC
    ``codes`` (encoded 4+j, alphabet.encode_extended) run on the
    extended base-(4+D) tables.  The DP is Viterbi under either scan
    semiring: a forward scan's hits still decode their best path."""
    base = 4 + len(codes) if codes else 4
    out: list[vr.ViterbiResult] = []
    for lo in range(0, len(profs), TRACE_BATCH):
        chunk_p = profs[lo : lo + TRACE_BATCH]
        chunk_s = seqs[lo : lo + TRACE_BATCH]
        H = len(chunk_p)
        Hp = 1
        while Hp < H:
            Hp *= 2
        pad_p = chunk_p + [chunk_p[0]] * (Hp - H)
        pad_s = chunk_s + [chunk_s[0]] * (Hp - H)
        Lp = max(len(s) for s in pad_s)
        block = build_profile_block(pad_p, kpad=kpad, codes=codes)
        eidx = np.stack([
            end_fragment_indices(
                fragment_indices(s, pad_to=Lp, base=base), base=base
            )
            for s in pad_s
        ])
        lens = np.array([len(s) for s in pad_s], np.int32)
        alt, ys = trace_dp(
            block, eidx, lens, multi_hits, hmmer3_compat, device
        )
        K = block.fm.shape[1]
        for h in range(H):
            ys_h = {k: v[:, h] for k, v in ys.items()}
            out.append(
                vr.ViterbiResult(float(alt[h]), walk(ys_h, int(lens[h]), K))
            )
    return out
