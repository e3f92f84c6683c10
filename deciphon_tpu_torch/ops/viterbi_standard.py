"""Batched Viterbi for standard (generic single-emission) profiles.

The counterpart of deciphon_tpu/ops/viterbi_standard.py, in plain torch
on an explicit device.  The JAX package computes this in XLA, outside
any Pallas kernel, so plain torch on the card is its port.  The
recurrence is the textbook dense HMM Viterbi,

    V'[j] = max_i (V[i] + T[i, j]) + E[j, x],

one step per position, batched over [reads, profiles] and chunked over
profiles so that the [reads, profiles, S, S] step stays small.

Profiles batch by padding states to a common S with NEG rows/columns;
reads batch by padding positions with symbol 0, and each score is taken
at position seq_len - 1 of the padded batch.  An empty read (seq_len 0)
takes position -1, the last padded one, as in the JAX package: it scores
as the batch's longest length of symbol 0 (ROADMAP.md, queue 3).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from deciphon_tpu_torch.models.standard import NEG, StandardProfile
from deciphon_tpu_torch.ops.scan_engine import resolve_device

# bytes of one [reads, profiles, S, S] step above which the profile axis
# is chunked
STEP_BYTES = 1 << 28


class StandardBlock(NamedTuple):
    """A batch of standard profiles padded to a common state count, f32
    on one device."""

    alt_start: torch.Tensor  # [B, S]
    alt_trans: torch.Tensor  # [B, S, S]
    alt_emis: torch.Tensor  # [B, S, A]
    alt_end: torch.Tensor  # [B, S]
    null_start: torch.Tensor  # [B, Sn]
    null_trans: torch.Tensor  # [B, Sn, Sn]
    null_emis: torch.Tensor  # [B, Sn, A]
    null_end: torch.Tensor  # [B, Sn]


def _pad_states(start, trans, emis, end, S: int):
    s = len(start)
    out_start = np.full(S, NEG, np.float32)
    out_start[:s] = np.maximum(start, NEG)
    out_trans = np.full((S, S), NEG, np.float32)
    out_trans[:s, :s] = np.maximum(trans, NEG)
    out_emis = np.full((S, emis.shape[1]), NEG, np.float32)
    out_emis[:s] = np.maximum(emis, NEG)
    out_end = np.full(S, NEG, np.float32)
    out_end[:s] = np.maximum(end, NEG)
    return out_start, out_trans, out_emis, out_end


def build_standard_block(profiles: list[StandardProfile],
                         device="cuda") -> StandardBlock:
    """The profiles padded to a common state count (NEG where a profile
    has no state), on ``device``; CUDA without a GPU raises."""
    dev = resolve_device(device)
    S = max(p.nstates for p in profiles)
    Sn = max(p.null_emis.shape[0] for p in profiles)
    alt = [_pad_states(p.alt_start, p.alt_trans, p.alt_emis, p.alt_end, S)
           for p in profiles]
    nul = [
        _pad_states(p.null_start, p.null_trans, p.null_emis, p.null_end, Sn)
        for p in profiles
    ]

    def stack(xs):
        return torch.from_numpy(np.stack(xs)).to(dev)

    return StandardBlock(
        *(stack([a[j] for a in alt]) for j in range(4)),
        *(stack([n[j] for n in nul]) for j in range(4)),
    )


def _viterbi(start, trans, emis, end, seqs, seq_len):
    """[Q, B] best-path logliks of one model quadruple ([B, S], [B, S, S],
    [B, S, A], [B, S]) against padded reads [Q, Lp]."""
    Q, Lp = seqs.shape
    B, S, _ = trans.shape
    # [B, S, A] -> [Q, B, S] per symbol column
    V = start[None] + emis[:, :, seqs[:, 0]].permute(2, 0, 1)
    finals = [torch.amax(V + end[None], dim=-1)]
    for t in range(1, Lp):
        step = torch.amax(V[..., :, None] + trans[None], dim=-2)
        V = step + emis[:, :, seqs[:, t]].permute(2, 0, 1)
        finals.append(torch.amax(V + end[None], dim=-1))
    finals = torch.stack(finals)  # [Lp, Q, B]
    # position seq_len - 1, wrapping to Lp - 1 for an empty read
    at = ((seq_len.long() - 1) % Lp)[None, :, None].expand(1, Q, B)
    return finals.gather(0, at)[0]


def standard_viterbi_scores(block: StandardBlock, seqs: torch.Tensor,
                            seq_len: torch.Tensor):
    """(alt [Q, B], null [Q, B]) f32 logliks for encoded, padded reads.

    seqs: [Q, Lp] symbol indices (padding values are read, but the score
    is taken at seq_len - 1).  seq_len: [Q].  Runs on the block's
    device."""
    dev = block.alt_trans.device
    seqs = seqs.to(dev).long()
    seq_len = seq_len.to(dev)
    Q = seqs.shape[0]
    B = block.alt_trans.shape[0]
    S = max(block.alt_trans.shape[1], block.null_trans.shape[1])
    chunk = max(1, STEP_BYTES // max(1, 4 * Q * S * S))
    out = []
    for lo in range(0, B, chunk):
        part = [t[lo:lo + chunk] for t in block]
        out.append((_viterbi(*part[:4], seqs, seq_len),
                    _viterbi(*part[4:], seqs, seq_len)))
    return (torch.cat([a for a, _ in out], dim=1),
            torch.cat([n for _, n in out], dim=1))


def scan_standard(
    profiles: list[StandardProfile],
    reads: list[str],
    lrt_threshold: float = 10.0,
    device="cuda",
):
    """LRT-gated standard-profile scan on ``device``: [(seq_idx,
    profile_idx, alt, null, lrt)] for every passing pair, ordered like
    the protein scan."""
    abc = profiles[0].abc
    block = build_standard_block(profiles, device)
    Lp = max(len(r) for r in reads)
    seqs = np.zeros((len(reads), Lp), np.int32)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        enc = abc.encode(r)
        seqs[i, : len(enc)] = enc
        lens[i] = len(enc)
    alt, null = standard_viterbi_scores(
        block, torch.from_numpy(seqs), torch.from_numpy(lens)
    )
    alt = alt.cpu().numpy().astype(np.float64)
    null = null.cpu().numpy().astype(np.float64)
    lrt = -2.0 * (null - alt)
    out = []
    for q, b in np.argwhere(
        np.isfinite(lrt) & (lrt >= lrt_threshold) & (alt > NEG / 2)
    ):
        out.append(
            (int(q), int(b), float(alt[q, b]), float(null[q, b]),
             float(lrt[q, b]))
        )
    return out
