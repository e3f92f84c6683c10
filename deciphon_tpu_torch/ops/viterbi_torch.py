"""Host profile blocks, fragment indexing and specials for the torch port.

The counterpart of deciphon_tpu/ops/viterbi_jax.py: the numpy block
constructor (``build_profile_block`` :66), the end-fragment index table
(``end_fragment_indices`` :119) and the length-dependent special
transitions (``_specials`` :136), re-implemented here because the JAX
module imports jax at load time.

The recurrence itself lives once, in ops/viterbi_cuda.py (``scores_plain``
and the CUDA kernel behind ``scores``); ``viterbi_scores`` below keeps the
JAX entry point's signature and [S, B] output layout on top of it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from deciphon_tpu_torch.models.frame import frag_layout
from deciphon_tpu_torch.models.profile import ProteinProfile

NEG = -1e30  # effective -inf that stays NaN-free through the D-chain sums


class ProfileBlock(NamedTuple):
    """Host (numpy) batch of profiles padded to a common core size Kpad.

    Same fields and layout as viterbi_jax.ProfileBlock; padding nodes
    carry NEG transitions and emissions so they never score."""

    fm: np.ndarray  # [B, Kpad, ntab] match fragment tables
    fi: np.ndarray  # [B, ntab] insert fragment table
    fn: np.ndarray  # [B, ntab] null/special fragment table (R,N,J,C)
    entry: np.ndarray  # [B, Kpad]
    mm_in: np.ndarray
    im_in: np.ndarray
    dm_in: np.ndarray
    md_in: np.ndarray
    dd_in: np.ndarray
    mi: np.ndarray
    ii: np.ndarray
    core_size: np.ndarray  # [B] int32


TRANS_NAMES = ("entry", "mm_in", "im_in", "dm_in", "md_in", "dd_in", "mi", "ii")


def _clamp(a, dtype=np.float32) -> np.ndarray:
    return np.maximum(np.asarray(a, dtype=np.float64), NEG).astype(dtype)


def build_profile_block(
    profiles: list[ProteinProfile], kpad: int | None = None,
    codes: tuple | None = None, dtype=np.float32,
) -> ProfileBlock:
    """Stack + pad profiles into a host block of fragment tables (the f64
    host tables of ProteinProfile.fragment_tables, clamped to NEG and
    cast to ``dtype``, f32 unless the caller keeps f64): base 4, or base
    4+len(codes) for reads holding the IUPAC ``codes`` (ntab = 1365,
    3906, 9331, ... rows)."""
    B = len(profiles)
    K = max(p.core_size for p in profiles)
    if kpad is not None:
        assert kpad >= K
        K = kpad
    codes = tuple(codes) if codes is not None else ()
    base = 4 + len(codes)
    ntab = frag_layout(base)[1] + 1
    fm = np.full((B, K, ntab), NEG, dtype)
    fi = np.empty((B, ntab), dtype)
    fn = np.empty((B, ntab), dtype)
    arrs = {n: np.full((B, K), NEG, dtype) for n in TRANS_NAMES}
    core = np.empty(B, np.int32)
    for b, p in enumerate(profiles):
        fmat, fins, fnull = p.fragment_tables(base=base, codes=codes)
        fm[b, : p.core_size] = _clamp(fmat, dtype)
        fi[b] = _clamp(fins, dtype)
        fn[b] = _clamp(fnull, dtype)
        for n in TRANS_NAMES:
            arrs[n][b, : p.core_size] = _clamp(getattr(p, n), dtype)
        core[b] = p.core_size
    return ProfileBlock(fm=fm, fi=fi, fn=fn, core_size=core, **arrs)


def end_fragment_indices(fidx: np.ndarray, base: int = 4) -> np.ndarray:
    """[Lp, 5] indices of base-``base`` fragments *ending* at position i.

    eidx[i-1, l-1] = index of seq[i-l : i] (from the start-indexed table
    of ops/emissions.fragment_indices), or the NEG sentinel row (the
    last row of the base's table) when the fragment would start before
    position 0."""
    Lp = fidx.shape[0]
    out = np.full((Lp, 5), frag_layout(base)[1], dtype=np.int32)
    for l in range(1, 6):
        out[l - 1 :, l - 1] = fidx[: Lp - l + 1, l - 1]
    return out


def specials(seq_len: torch.Tensor, multi_hits: bool, hmmer3_compat: bool,
             dtype: torch.dtype = torch.float32):
    """Length-dependent special transitions per read, tensors [S] of
    ``dtype`` (f32 for the kernels).

    Mirrors protein_profile_setup (reference src/model/protein_profile.c:
    155-216) and viterbi_jax._specials.  EJ and EC do not depend on the
    length and come back as floats.  Length-0 rows (batch padding) are
    scored as length 1; they never reach the capture at i == seq_len."""
    L = seq_len.to(dtype).clamp_min(1.0)
    q = 0.5 if multi_hits else 0.0
    log_q = float(np.log(0.5)) if multi_hits else NEG
    denom = torch.log(L + (2.0 + q / (1.0 - q)))
    lp = torch.log(L) - denom
    real = np.float32 if dtype == torch.float32 else np.float64
    l1p = float(np.log(real(2.0 + q / (1.0 - q)))) - denom
    lr = torch.log(L) - torch.log(L + 1.0)
    nn = torch.zeros_like(lp) if hmmer3_compat else lp
    return dict(
        NN=nn, NB=l1p, EC=float(np.log(1.0 - q)), CC=nn, CT=l1p,
        EJ=log_q, JJ=nn, JB=l1p, RR=lr,
    )


def viterbi_scores(
    block: ProfileBlock,
    eidx: np.ndarray,  # [S, Lp, 5] int32 end-fragment indices
    seq_len: np.ndarray,  # [S] int32
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    semiring: str = "max",
):
    """Score every (sequence, profile) pair: (alt [S, B], null [S, B]) f32
    CPU tensors — the port of viterbi_jax.viterbi_scores (:293), run
    through the plain recurrence.  ``semiring="logsumexp"`` runs the
    forward algorithm.  The engine reaches the kernel through
    ``viterbi_cuda.CudaBlock`` instead."""
    from deciphon_tpu_torch.ops import viterbi_cuda as vc

    return vc.scores(
        vc.pack_numpy_block(block),
        torch.as_tensor(np.asarray(eidx, np.int32)),
        torch.as_tensor(np.asarray(seq_len, np.int32)),
        multi_hits=multi_hits, hmmer3_compat=hmmer3_compat,
        semiring=semiring,
    )


def forward_scores(
    block: ProfileBlock,
    eidx: np.ndarray,
    seq_len: np.ndarray,
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
):
    """Forward-algorithm (alt, null) log-likelihoods [S, B]: logsumexp
    over all state paths (viterbi_jax.forward_scores :322)."""
    return viterbi_scores(
        block, eidx, seq_len, multi_hits=multi_hits,
        hmmer3_compat=hmmer3_compat, semiring="logsumexp",
    )
