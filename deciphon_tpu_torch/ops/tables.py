"""Device-side synthesis of frame-state fragment score tables, in torch.

The counterpart of deciphon_tpu/ops/tables.py.  Builds the per-node
fragment tables (models/frame.py) on the engine's device from compact
per-node inputs instead of shipping host tables:

    probs[n, f] = sum_t  Me[n, midx(f,t)] * (qq[n, pair(f,t)] * coef_t)

Base-4 tables (ACGT reads, 1365 rows) take the codon marginals [125]
and background nucleotide probabilities [5], as frame.fragment_table
does.  Extended tables over base 4+D (reads holding D distinct IUPAC
codes) take the codon probabilities [64] instead, as
frame.fragment_table_codes does: the [S^3] pattern marginals Me
(S = 5 + D internal symbols) are an f64 product with the 0/1 matrix
frame.ext_agg, and observed symbol 4+j maps to internal symbol 5+j.

The JAX version writes each length's selection as two one-hot matmuls
(tables.py:81-103) and has to pin Precision.HIGHEST, because the TPU
default truncates matmul inputs to bf16 (tables.py:90-97).  Here the
selections are index gathers, summed term by term, so neither TF32 nor
bf16 can enter: every product is an f32 multiply of the selected
entries, and the one matmul (the pattern marginals) runs in f64.

On a card, extended tables come from csrc/tables.cu instead
(``block_tables``): one launch per block, or per profile slice of one
(ops/scan_engine.EXT_SLICE_BYTES), writes the kernels' layout
directly, with the same products and sums in the same order, from the
term lists of ``term_rows``; ``synth_fragment_tables`` stays the CPU's
path and the kernel's plain version (``block_tables_plain``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from deciphon_tpu_torch.models.frame import (
    IUPAC_SUBSETS,
    TERMS,
    _enumerate_frags,
    ext_agg,
    frag_layout,
    term_coefs,
)
from deciphon_tpu_torch.ops.viterbi_torch import NEG
from deciphon_tpu_torch.utils import trace

# elements of one [rows, fragments] temporary: sets the row chunk, so
# base-4 tables go 8192 rows at a time and taller tables fewer
CHUNK_ELEMS = 1 << 23
# the term classes in the order of a term's class field
CLASSES = tuple(term_coefs(0.0))
# launches of csrc/tables.cu made by launch_tables (a plain count, as
# viterbi_cuda.LAUNCHES); the scan's counter is "launch.tables"
LAUNCHES = {"tables": 0}


@functools.cache
def _length_terms(codes: tuple = ()):
    """Per fragment length over base 4+D: (midx [F, T] into the [S^3]
    pattern marginals, pair [F, T] into the [S^2] background pairs,
    class names [T]); S = 5 + D, internal symbol 4 = any / no insertion."""
    base = 4 + len(codes)
    S = 5 + len(codes)
    obs2int = np.concatenate([np.arange(4), np.arange(5, S)])
    out = []
    for length in range(1, 6):
        frags = obs2int[_enumerate_frags(length, base)]  # [F, length]
        F = frags.shape[0]
        fragx = np.concatenate([frags, np.full((F, 1), 4, frags.dtype)], 1)
        marg_sel, ins_sel, cls = TERMS[length]
        sel = np.where(marg_sel < 0, length, marg_sel)
        zabc = fragx[:, sel]  # [F, T, 3]
        midx = (zabc[..., 0] * S + zabc[..., 1]) * S + zabc[..., 2]
        isel = np.where(ins_sel < 0, length, ins_sel)
        iidx = fragx[:, isel]  # [F, T, 2]
        pair = iidx[..., 0] * S + iidx[..., 1]
        out.append((midx.astype(np.int64), pair.astype(np.int64), cls))
    return out


@functools.cache
def term_rows(codes: tuple = ()):
    """The term lists of csrc/tables.cu over base 4+len(codes): (start
    [ntab + 1] int32, word [start[-1]] uint32, combo [C] int32).
    Fragment row f (in frag_layout's order; the sentinel, the last, has
    none) sums the terms start[f] .. start[f+1]-1 in ``_length_terms``'
    order, each a word midx | c << 16, where combo[c] = i | j << 8 |
    class << 16 is the term's background pair i * S + j and its class
    (an index into CLASSES)."""
    S = 5 + len(codes)
    if S > 16:
        raise ValueError(f"{len(codes)} codes: a term word holds S <= 16")
    offsets, sentinel = frag_layout(4 + len(codes))
    counts = np.zeros(sentinel + 1, np.int64)
    keys = []
    midxs = []
    for length, (midx, pair, cls) in enumerate(_length_terms(codes), 1):
        F, T = midx.shape
        counts[offsets[length] : offsets[length] + F] = T
        ci = np.array([CLASSES.index(c) for c in cls], np.int64)
        keys.append((pair // S | (pair % S) << 8 | ci << 16).reshape(-1))
        midxs.append(midx.reshape(-1))
    combo, which = np.unique(np.concatenate(keys), return_inverse=True)
    if counts.max() > 32 or len(combo) > 0xFFFF:
        raise ValueError("a row of more than 32 terms, or too many pairs")
    start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    word = np.concatenate(midxs) | which.reshape(-1) << 16
    return start, word.astype(np.uint32), combo.astype(np.int32)


def coef_row(eps: float) -> np.ndarray:
    """[len(CLASSES)] f32: each class's coefficient (frame.term_coefs)."""
    coefs = term_coefs(eps)
    return np.array([coefs[c] for c in CLASSES], np.float32)


class DeviceTerms(NamedTuple):
    """A read class's constants of the synthesis on one device
    (``device_terms``)."""

    agg: torch.Tensor  # [S^3, 64] f64, frame.ext_agg(codes)
    subsets: list  # per code, its IUPAC subset's indices, int64
    start: torch.Tensor  # term_rows' start, int32
    word: torch.Tensor  # term_rows' word, as int32
    combo: torch.Tensor  # term_rows' combo, int32
    coef: torch.Tensor  # coef_row(eps), f32


@functools.cache
def device_terms(codes: tuple, eps: float, device) -> DeviceTerms:
    """The constants of read class ``codes`` on ``device`` (a
    torch.device with its index), uploaded once and kept: a copy from
    pageable memory would make the host wait for every queued kernel."""
    start, word, combo = term_rows(codes)

    def up(a):
        return torch.as_tensor(a, device=device)

    return DeviceTerms(
        up(ext_agg(codes)),
        [up(np.array(IUPAC_SUBSETS[c], np.int64)) for c in codes],
        up(start), up(word.view(np.int32)), up(combo), up(coef_row(eps)),
    )


def _ext_inputs(codonp, qp, codes: tuple, eps: float):
    """(Me [N, S^3], qe [N, S]) f32 for extended tables, from codon
    probabilities [N, 64] and background probabilities [N, 5]: the
    pattern marginals as an f64 product with frame.ext_agg, qe the
    concrete masses, the sentinel 1 and one subset sum per code
    (frame.ext_q); the constants from ``device_terms``."""
    terms = device_terms(codes, float(eps), codonp.device)
    me = (codonp.double() @ terms.agg.T).float()
    qe = [qp[:, :4], torch.ones_like(qp[:, :1])]
    qe += [qp[:, sub].sum(1, keepdim=True) for sub in terms.subsets]
    return me, torch.cat(qe, 1)


def synth_fragment_tables(emis, qp, eps: float, codes: tuple = (),
                          row_chunk: int | None = None):
    """[N, ntab] f32 log fragment tables on the inputs' device, ntab =
    frag_layout(4 + len(codes))[1] + 1 (1365 for base 4).

    Args:
      emis: [N, 125] codon-marginal probabilities (exp of codon_marg)
        for base-4 tables; [N, 64] codon probabilities (exp of the codon
        log-probs) when ``codes`` is not empty.
      qp: [N, 5] background nucleotide probabilities, qp[:, 4] = 1.
      eps: indel error rate.
      codes: the IUPAC codes of the read class (base 4 + len(codes)).

    log(0) clamps to NEG, and the sentinel column (the last) is NEG.
    Rows go in chunks of ``row_chunk`` to bound the [rows, F]
    temporaries."""
    emis = torch.as_tensor(emis, dtype=torch.float32)
    dev = emis.device
    qp = torch.as_tensor(qp, dtype=torch.float32, device=dev)
    codes = tuple(codes)
    if codes:
        emis, qp = _ext_inputs(emis, qp, codes, eps)
    S = qp.shape[1]
    offsets, sentinel = frag_layout(4 + len(codes))
    if row_chunk is None:
        row_chunk = max(1, CHUNK_ELEMS // (4 + len(codes)) ** 5)
    coefs = term_coefs(eps)
    N = emis.shape[0]
    out = torch.empty((N, sentinel + 1), dtype=torch.float32, device=dev)
    out[:, sentinel] = NEG
    terms = [
        (
            torch.as_tensor(midx, device=dev),
            torch.as_tensor(pair, device=dev),
            [float(np.float32(coefs[c])) for c in cls],
        )
        for midx, pair, cls in _length_terms(codes)
    ]
    for r0 in range(0, N, row_chunk):
        mp = emis[r0 : r0 + row_chunk]
        q = qp[r0 : r0 + row_chunk]
        qq = (q[:, :, None] * q[:, None, :]).reshape(q.shape[0], S * S)
        for length, (midx, pair, coef) in enumerate(terms, start=1):
            acc = None
            for t, c in enumerate(coef):
                term = mp[:, midx[:, t]] * (qq[:, pair[:, t]] * c)
                acc = term if acc is None else acc + term
            lo = offsets[length]
            out[r0 : r0 + row_chunk, lo : lo + midx.shape[0]] = (
                torch.log(acc).clamp_min(NEG)
            )
    return out


def table_bytes(codes: tuple, kpad: int) -> int:
    """Bytes of one profile's fm and fin over base 4+len(codes) at padded
    width ``kpad``: ntab rows of kpad nodes and of its insert and null
    rows, f32."""
    return 4 * (frag_layout(4 + len(codes))[1] + 1) * (kpad + 2)


def block_tables_plain(emis, qp, eps: float, codes: tuple, B: int,
                       kpad: int):
    """(fm [B, ntab, kpad], fin [B, 2, ntab]) f32 of a block, on the
    inputs' device, by ``synth_fragment_tables``, from compact inputs
    (viterbi_cuda.CompactInputs) whose rows are the nodes b*kpad + k,
    then the insert and null rows 2b + {0, 1}: ``emis`` [B*kpad + 2B,
    W] (the codon marginals, W = 125, for base 4; the codon
    probabilities, W = 64, when ``codes`` is not empty) and ``qp``
    [B*kpad + 2B, 5]."""
    n = B * kpad
    fm = synth_fragment_tables(emis[:n], qp[:n], eps, codes)
    ntab = fm.shape[1]
    fm = fm.reshape(B, kpad, ntab).transpose(1, 2).contiguous()
    fin = synth_fragment_tables(emis[n:], qp[n:], eps, codes)
    return fm, fin.reshape(B, 2, ntab)


def block_tables(emis, qp, eps: float, codes: tuple, B: int, kpad: int):
    """``block_tables_plain``'s tables.  Extended ones (``codes`` not
    empty) on a card by one launch of csrc/tables.cu after the pattern
    marginals' f64 product (``launch_tables``); base-4 ones, and any on
    the CPU, by ``block_tables_plain``.  Extended ones add their fm and
    fin bytes, which the launch writes, to the scan's counter
    ``tables_written_bytes``."""
    if not (codes and emis.is_cuda):
        fm, fin = block_tables_plain(emis, qp, eps, codes, B, kpad)
    else:
        me, qe = _ext_inputs(emis, qp, codes, eps)
        fm, fin = launch_tables(me, qe, eps, codes, B, kpad)
    if codes:
        trace.count("tables_written_bytes", 4 * (fm.numel() + fin.numel()))
    return fm, fin


def launch_tables(me, qe, eps: float, codes: tuple, B: int, kpad: int):
    """One launch of csrc/tables.cu on the inputs' card and its current
    stream: (fm [B, ntab, kpad], fin [B, 2, ntab]) f32 from the rows'
    pattern marginals ``me`` [B*kpad + 2B, S^3] and masses ``qe``
    [B*kpad + 2B, S] (``_ext_inputs``; for base 4 the codon marginals
    and qp).  No fallback: a failed build or launch raises."""
    from deciphon_tpu_torch.ops import _build

    S = 5 + len(codes)
    R = B * kpad + 2 * B
    dev = me.device
    for name, t, w in (("me", me, S**3), ("qe", qe, S)):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != (R, w)):
            raise ValueError(f"{name}: need a contiguous f32 [{R}, {w}] "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if kpad <= 0 or kpad % 32:
        raise ValueError(f"kpad={kpad}: need a positive multiple of 32")
    terms = device_terms(codes, float(eps), dev)
    ntab = terms.start.shape[0] - 1
    fm = torch.empty((B, ntab, kpad), dtype=torch.float32, device=dev)
    fin = torch.empty((B, 2, ntab), dtype=torch.float32, device=dev)
    if B == 0:
        return fm, fin
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.dcp_tables(
            me.data_ptr(), qe.data_ptr(), terms.start.data_ptr(),
            terms.word.data_ptr(), terms.combo.data_ptr(),
            terms.coef.data_ptr(), fm.data_ptr(), fin.data_ptr(),
            B, kpad, ntab, S, terms.combo.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"tables kernel launch failed: {_build.error_string(rc)}")
    LAUNCHES["tables"] += 1
    trace.count("launch.tables")
    return fm, fin
