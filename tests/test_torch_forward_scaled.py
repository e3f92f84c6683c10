"""The forward kernel's probability-space arithmetic, mirrored on the CPU.

csrc/forward.cu runs the forward recurrence in scaled probability space:
linear f32 values times powers of two (one exponent per thread's group
of nodes and position, one each for the specials N, R, J with C, and E),
lookback slots joined at 2^(slot exponent - position exponent),
emissions exponentiated from the log tables with exp2f(log2(e) x), the
transitions as probability planes (``CudaBlock.ptrans``) and the D-chain
as a scan of affine maps.  ``forward_scaled`` below is that arithmetic in
plain torch, node for node (only the order of the sums differs from the
kernel's threads and warps).  It is held against the JAX reference (the
Pallas kernel in interpret mode, semiring="logsumexp") and the port's
log-space plain version ``viterbi_cuda.scores_plain`` (on base-6 tables
the JAX package's XLA engine stands in for the Pallas kernel) at the
tolerance chip_smoke.py holds the kernel to, 1e-3 + 1e-5 * |ref|, on
dead DD links, reads of 0, 1, 5 and 300 nt (300 nt underflows f32
unscaled), K = 8 and 129 padded to LANE, base-5 and base-6 tables and
both flag pairs; on a strong hit, whose null lies ~270 nats below its
alt (the null R loop keeps its own exponent); on reads holding two
copies of a strong domain, whose second copy a single exponent per
position would lose; and on a 600-nt read against the JAX package's f64
oracle, at a tighter 2e-4.  The probability planes are held against the
log planes.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from deciphon_tpu.models.alphabet import DNA, encode_extended
from deciphon_tpu.models.frame import frag_layout
from deciphon_tpu.models.h3reader import build_profile
from deciphon_tpu.models.h3writer import random_h3
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import viterbi_jax as vj
from deciphon_tpu.ops import viterbi_pallas as vp
from deciphon_tpu.ops import viterbi_ref as vr
from deciphon_tpu.ops.emissions import fragment_indices
from deciphon_tpu_torch.models.alphabet import STANDARD_CODE
from deciphon_tpu_torch.models.h3reader import build_profile as pbuild
from deciphon_tpu_torch.models.h3writer import random_h3 as prandom_h3
from deciphon_tpu_torch.models.profile import sample_profile as psample
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops import viterbi_torch as vt

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
ZERO_X = -(1 << 28)  # the kernel's exponent of a zero
TOL = (1e-3, 1e-5)  # chip_smoke.py's forward tolerance (abs, rel)
FLAGS = [(True, False), (False, True)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and these tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prob(logp):
    """A log table entry as a probability, as the kernel's exp2f."""
    return torch.exp2(logp * LOG2E)


def _pow2(d):
    """2^d exactly for an int tensor: 0 far below the subnormals, capped
    at 2^127 as the kernel's (where it only ever scales a zero)."""
    return torch.ldexp(torch.ones(d.shape), d.clamp(-200, 127).float())


def _live(v, x):
    """The exponent x of v, or ZERO_X where v is 0."""
    return torch.where(v > 0, x, torch.full_like(x, ZERO_X))


def _join(*pairs):
    """Sum of (value, exponent) pairs at the largest live exponent."""
    xs = [_live(v, x) for v, x in pairs]
    top = torch.stack(xs).amax(0)
    return sum(v * _pow2(x - top) for (v, _), x in zip(pairs, xs)), top


def _rescale(m, x):
    """(factor, exponent): m * factor in [0.5, 1) at exponent x + the
    binary exponent of m (at most 2^126 up for a subnormal m, as the
    kernel's); ZERO_X for a zero."""
    e = torch.frexp(m).exponent.clamp(min=-126)
    return _pow2(-e), torch.where(m > 0, x + e, torch.full_like(x, ZERO_X))


def _log_scaled(x, e):
    """log(x * 2^e), NEG for a zero."""
    out = torch.log(x).double() + e.double() * LN2
    return torch.where(x > 0, out.float(), torch.tensor(vt.NEG))


def forward_scaled(blk, eidx, seq_len, multi_hits=True, hmmer3_compat=False):
    """(alt [S, B], null [S, B]): the forward kernel's arithmetic.  Nodes
    come in groups of the kernel's NPT (one thread's), each group with
    one exponent per position; the specials N, R, J and C together, and
    E, with one each."""
    fm, fin = blk.fm, blk.fin
    B, _, K = fm.shape
    S = eidx.shape[0]
    G = 4 if K <= 128 else 8  # the kernel's NPT
    NG = K // G

    def grp(t):  # [S, B, K] -> [S, B, NG, G]
        return t.reshape(S, B, NG, G)

    def nodes(t):  # a per-group tensor over each group's nodes
        return t.repeat_interleave(G, -1)

    def zero_x(*shape):
        return torch.full(shape, ZERO_X, dtype=torch.int32)

    eidx = eidx.long()
    xt = vt.specials(seq_len, multi_hits, hmmer3_compat)
    NN, NB, RR = (torch.exp(xt[k])[:, None] for k in ("NN", "NB", "RR"))
    EJ = torch.exp(torch.tensor(xt["EJ"], dtype=torch.float32))
    EC = torch.exp(torch.tensor(xt["EC"], dtype=torch.float32))
    entry, mm, im, dm, mi, ii, md, dd = blk.ptrans.unbind(1)

    zeros, z2 = torch.zeros(S, B, K), torch.zeros(S, B)
    # position 0: S -> B -> entry, every other slot dead; slot exponents
    # per group (nodes) and per value (specials)
    c0 = grp((NB[:, :, None] * entry).expand(S, B, K))
    f, x0 = _rescale(c0.amax(-1), torch.zeros(S, B, NG, dtype=torch.int32))
    ring_cs = [(c0 * f[..., None]).reshape(S, B, K)] + [zeros] * 4
    ring_ic = [zeros] * 5
    ring_x = [x0] + [zero_x(S, B, NG)] * 4
    sp = {k: [z2] * 5 for k in "NJCER"}
    spx = {k: [zero_x(S, B)] * 5 for k in ("N", "R", "JC", "E")}
    alt = torch.full((S, B), vt.NEG)
    null = alt.clone()
    for i in range(1, min(int(seq_len.max()), eidx.shape[1]) + 1):
        idx = eidx[:, i - 1, :]
        em_m = fm[:, idx, :]  # [B, S, 5, K]
        em_in = fin[:, :, idx]  # [B, 2, S, 5]
        slots = [(i - l) % 5 for l in range(1, 6)]
        X = torch.stack([ring_x[q] for q in slots]).amax(0)  # [S, B, NG]
        # S (1 at exponent 0) feeds N and R up to position 5
        st = [torch.zeros(S, B, dtype=torch.int32)] if i <= 5 else []
        XN = torch.stack([spx["N"][q] for q in slots] + st).amax(0)
        XR = torch.stack([spx["R"][q] for q in slots] + st).amax(0)
        XJC = torch.stack([spx["JC"][q] for q in slots]
                          + [spx["E"][q] for q in slots]).amax(0)
        accM = accI = 0.0
        accN = accJ = accC = accR = 0.0
        for l, q in enumerate(slots, 1):
            sc = nodes(_pow2(ring_x[q] - X))
            en = _prob(em_in[:, 1, :, l - 1].T)
            emi = _prob(em_in[:, 0, :, l - 1].T)[..., None] * sc
            cm = ring_cs[q] * _prob(em_m[:, :, l - 1].transpose(0, 1))
            accM = accM + cm * sc
            accI = accI + ring_ic[q] * emi
            start = 1.0 if l == i else 0.0
            nn = NN * en
            accN = accN + (sp["N"][q] * _pow2(spx["N"][q] - XN)
                           + start * _pow2(-XN)) * nn
            accR = accR + (sp["R"][q] * RR * _pow2(spx["R"][q] - XR)
                           + start * _pow2(-XR)) * en
            fe = sp["E"][q] * _pow2(spx["E"][q] - XJC)
            fj = _pow2(spx["JC"][q] - XJC)
            accJ = accJ + (fe * EJ + sp["J"][q] * fj) * nn
            accC = accC + (fe * EC + sp["C"][q] * fj) * nn
        # D[k+1] = D[k] dd[k] + M[k] md[k] from D = 0 before node 0: each
        # group's prefix at its exponent, then the groups' maps (a, b 2^x)
        # composed in order at the larger exponent
        a = grp(dd.expand(S, B, K))
        pa = torch.cumprod(a, -1)
        pb = grp(accM * md).clone()
        for n in range(1, G):
            pb[..., n] = pb[..., n - 1] * a[..., n] + pb[..., n]
        din = torch.zeros(S, B, NG)
        dx = zero_x(S, B, NG)
        v, vx = z2, zero_x(S, B)
        for g in range(NG):
            din[..., g], dx[..., g] = v, vx
            v, vx = _join((pa[..., g, -1] * v, vx),
                          (pb[..., g, -1], X[..., g]))
        XP = torch.maximum(X, _live(din, dx))  # the group's working exponent
        rs = _pow2(X - XP)
        accM = accM * nodes(rs)
        accI = accI * nodes(rs)
        din = din * _pow2(dx - XP)
        pa0 = torch.cat([torch.ones(S, B, NG, 1), pa[..., :-1]], -1)
        pb0 = torch.cat([torch.zeros(S, B, NG, 1), pb[..., :-1]], -1)
        VD = (pa0 * din[..., None] + pb0 * rs[..., None]).reshape(S, B, K)
        esum = grp(accM + VD).sum(-1)
        VE, XE = _join(*((esum[..., g], XP[..., g]) for g in range(NG)))
        VB, XB = _join((accN, XN), (accJ, XJC), (VE * EJ, XE))
        VB = VB * NB
        VT, XT = _join((VE * EC, XE), (accC, XJC))
        VT = VT * NB
        hit = (seq_len == i)[:, None]
        alt = torch.where(hit, _log_scaled(VT, XT), alt)
        null = torch.where(hit, _log_scaled(accR, XR), null)

        # position i's node slots, each group at its largest value's
        # exponent; the core out-flow shifts by one node, across group
        # edges with the exponent of the group it comes from
        core = grp(accM * mm + accI * im + VD * dm)
        prev = torch.cat([torch.zeros(S, B, 1), core[..., :-1, -1]], -1)
        px = _live(prev, torch.cat([zero_x(S, B, 1), XP[..., :-1]], -1))
        bx = _live(VB, XB)[..., None]
        e = torch.maximum(torch.maximum(XP, px), bx)
        ro = _pow2(XP - e)[..., None]
        csh = torch.cat([(prev * _pow2(px - e))[..., None],
                         core[..., :-1] * ro], -1)
        cs = (VB[..., None] * _pow2(bx - e))[..., None] * grp(
            entry.expand(S, B, K)) + csh
        ic = grp(accM * mi + accI * ii) * ro
        f, ring_x[i % 5] = _rescale(torch.maximum(cs.amax(-1), ic.amax(-1)), e)
        ring_cs[i % 5] = (cs * f[..., None]).reshape(S, B, K)
        ring_ic[i % 5] = (ic * f[..., None]).reshape(S, B, K)
        # position i's specials, each in [0.5, 1) at its own exponent
        for k, val, x in (("N", accN, XN), ("R", accR, XR), ("E", VE, XE)):
            f, spx[k][i % 5] = _rescale(val, x)
            sp[k][i % 5] = val * f
        f, spx["JC"][i % 5] = _rescale(torch.maximum(accJ, accC), XJC)
        sp["J"][i % 5], sp["C"][i % 5] = accJ * f, accC * f
    return alt, null


def consensus(prof) -> str:
    """The DNA of a profile's most likely codon at every node."""
    return "".join(STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
                   for b in map(int, np.argmax(prof.match_codonp, 1)))


def _within(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    excess = np.abs(got - ref) - (TOL[0] + TOL[1] * np.abs(ref))
    assert excess.max() <= 0, (
        f"{what}: max|d| {np.abs(got - ref).max():.3g}")


def _case(ks, seed, kpad, reads, codes=(), dead=None, peak=0.0):
    """JAX block, port block (packed) and eidx for ``reads``; profile
    ``dead`` gets two dead DD links inside its core.  ``peak`` > 0 makes
    HMMER-shaped profiles whose match columns put that mass on one amino
    acid (h3writer.random_h3), instead of sample_profile's flat ones."""
    if peak:
        jprofs = [build_profile(random_h3(seed + j, k, peak=peak))
                  for j, k in enumerate(ks)]
        pprofs = [pbuild(prandom_h3(seed + j, k, peak=peak))
                  for j, k in enumerate(ks)]
    else:
        jprofs = [sample_profile(seed + j, k) for j, k in enumerate(ks)]
        pprofs = [psample(seed + j, k) for j, k in enumerate(ks)]
    if dead is not None:
        k = ks[dead]
        dd = jprofs[dead].dd_in.copy()
        dd[[k // 3, 2 * k // 3]] = -np.inf
        jprofs[dead] = replace(jprofs[dead], dd_in=dd)
        pprofs[dead] = replace(pprofs[dead], dd_in=dd)
    block = vj.build_profile_block(jprofs, kpad=kpad, codes=codes or None)
    pblock = vt.build_profile_block(pprofs, kpad=kpad, codes=codes)
    base = 4 + len(codes)
    Lp = max(1, max(map(len, reads)))
    encs = [encode_extended(r)[0] if codes else DNA.encode(r) for r in reads]
    eidx = np.stack([
        vt.end_fragment_indices(
            fragment_indices(e, pad_to=Lp, base=base), base)
        for e in encs
    ])
    slen = np.array([len(r) for r in reads], np.int32)
    return jprofs, pprofs, block, vc.pack_numpy_block(pblock), eidx, slen


def _pallas(block, eidx, slen, mh, h3, codes=()):
    """The TPU kernel's forward in interpret mode, on the rows of
    nonzero length (its eidx padded with the base's sentinel row)."""
    rows = np.flatnonzero(slen > 0)
    Lp = max(255, eidx.shape[1])
    eidx_p = np.full((len(rows), Lp, 5), frag_layout(4 + len(codes))[1],
                     np.int32)
    eidx_p[:, : eidx.shape[1]] = eidx[rows]
    alt, null = vp.viterbi_scores_pallas(
        block, eidx_p, slen[rows], multi_hits=mh, hmmer3_compat=h3,
        interpret=True, semiring="logsumexp",
    )
    return rows, alt, null


def _check(blk, block, eidx, slen, mh, h3, codes=(), dead=None):
    te, ts = torch.from_numpy(eidx), torch.from_numpy(slen)
    alt, null = forward_scaled(blk, te, ts, mh, h3)
    assert torch.isfinite(alt).all() and torch.isfinite(null).all()
    dead_rows = slen == 0
    assert torch.all(alt[dead_rows] == vt.NEG)
    assert torch.all(null[dead_rows] == vt.NEG)
    palt, pnull = vc.scores_plain(blk, te, ts, mh, h3, semiring="logsumexp")
    _within(alt, palt, "alt vs scores_plain")
    _within(null, pnull, "null vs scores_plain")
    if len(codes) < 2:
        rows, ralt, rnull = _pallas(block, eidx, slen, mh, h3, codes)
        _within(alt[rows], ralt, "alt vs Pallas (interpret)")
        _within(null[rows], rnull, "null vs Pallas (interpret)")
    else:
        # base-6 tables: the Pallas kernel in interpret mode disagrees with
        # the JAX package's own XLA engine on alt (by up to ~3 nats), so
        # the JAX reference here is that engine, as in test_torch_viterbi;
        # it does not take -inf DD links (its alt for such a profile comes
        # out above 0), so profile ``dead`` is held to scores_plain only
        ralt, rnull = vj.viterbi_scores(block, eidx, slen, mh, h3,
                                        semiring="logsumexp")
        live = [b for b in range(alt.shape[1]) if b != dead]
        _within(alt[:, live], np.asarray(ralt)[:, live], "alt vs XLA engine")
        _within(null, rnull, "null vs XLA engine")
    return alt


@pytest.mark.parametrize("mh,h3", FLAGS)
def test_k8_short_reads_dead_dd(mh, h3):
    """Cores 2..8 padded to 32 nodes, one with two dead DD links; reads
    of 0, 1, 5 and 40 nt."""
    rng = np.random.default_rng(3)
    reads = ["".join(rng.choice(list("ACGT"), n)) for n in (0, 1, 5, 40)]
    _, _, block, blk, eidx, slen = _case([8, 2, 5, 7, 8], 11, 8, reads,
                                         dead=4)
    assert blk.kpad == vc.LANE
    _check(blk, block, eidx, slen, mh, h3)


@pytest.mark.parametrize("mh,h3", FLAGS)
def test_k129_read_of_300(mh, h3):
    """K = 129 padded to 160 with cores down to 3 and a dead-DD profile;
    a 300-nt read, whose probabilities fall far below f32's smallest
    subnormal (the exponents carry them), beside 5-, 1- and 0-nt reads."""
    rng = np.random.default_rng(5)
    reads = ["".join(rng.choice(list("ACGT"), n)) for n in (300, 5, 1, 0)]
    _, _, block, blk, eidx, slen = _case([129, 64, 3, 129], 40, 129, reads,
                                         dead=3)
    assert blk.kpad == 160
    alt = _check(blk, block, eidx, slen, mh, h3)
    assert alt[0].max() < np.log(np.finfo(np.float32).smallest_subnormal)


@pytest.mark.parametrize("codes", [("N",), ("N", "R")])
def test_extended_tables(codes):
    """Base-5 and base-6 tables: codes[0] at positions 1-5 (lookbacks
    that also reach the sentinel row) and codes[-1] mid-read."""
    rng = np.random.default_rng(7)
    reads = []
    for k in range(5):
        r = list(rng.choice(list("ACGT"), int(rng.integers(14, 40))))
        r[k] = codes[0]
        r[9] = codes[-1]
        reads.append("".join(r))
    reads.append("".join(codes * 3)[:3])  # every fragment ambiguous
    ks = [int(rng.integers(3, 20)) for _ in range(4)]
    _, _, block, blk, eidx, slen = _case(ks, 1, 20, reads, codes, dead=0)
    assert blk.fm.shape[1] == {1: 3906, 2: 9331}[len(codes)]
    _check(blk, block, eidx, slen, True, False, codes, dead=0)


@pytest.mark.parametrize("codes", [(), ("N",)])
def test_prob_planes(codes):
    """ptrans is exp of the log transitions (exactly, from the same f32
    values), exactly 0 for dead DD links, padding nodes and the out-links
    of the last node, and the same bits through pack_compact
    (CudaBlock.from_profiles) and pack_numpy_block."""
    ks = [12, 5, 9]
    profiles = [psample(20 + j, k) for j, k in enumerate(ks)]
    dd = profiles[0].dd_in.copy()
    dd[[4, 8]] = -np.inf
    profiles[0] = replace(profiles[0], dd_in=dd)
    host = vt.build_profile_block(profiles, kpad=12, codes=codes)
    got = vc.pack_numpy_block(host)
    dev = vc.CudaBlock.from_profiles(profiles, kpad=12, device="cpu",
                                     codes=codes)
    assert torch.equal(dev.ptrans, got.ptrans)
    assert got.ptrans.shape == got.trans.shape == (3, vc.NPLANES, 32)
    assert got.ptrans.dtype == torch.float32

    def expf(logp):
        return torch.from_numpy(np.exp(np.asarray(logp, np.float64))
                                .astype(np.float32))

    p = got.ptrans
    for q, pl in ((vc.Q_ENTRY, vc.P_ENTRY), (vc.Q_MM_OUT, vc.P_MM_OUT),
                  (vc.Q_IM_OUT, vc.P_IM_OUT), (vc.Q_DM_OUT, vc.P_DM_OUT),
                  (vc.Q_MI, vc.P_MI), (vc.Q_II, vc.P_II)):
        assert torch.equal(p[:, q], expf(got.trans[:, pl].numpy()))
    for q, name in ((vc.Q_MD_OUT, "md_in"), (vc.Q_DD_OUT, "dd_in")):
        src = getattr(host, name)  # destination-indexed, f32
        assert torch.equal(p[:, q, : 11], expf(src[:, 1:12]))
    # dead links and padding are exactly 0; live links are positive
    assert p[0, vc.Q_DD_OUT, 3] == 0 and p[0, vc.Q_DD_OUT, 7] == 0
    for b, k in enumerate(ks):
        assert torch.all(p[b, :, k:] == 0)
        for q in (vc.Q_MM_OUT, vc.Q_IM_OUT, vc.Q_DM_OUT, vc.Q_MD_OUT,
                  vc.Q_DD_OUT):
            assert p[b, q, k - 1] == 0  # no node after the last
        assert torch.all(p[b, vc.Q_MM_OUT, : k - 1] > 0)
    assert torch.all((p >= 0) & (p <= 1))


def test_strong_hit_null_keeps_its_own_scale():
    """A consensus read of a peaked profile: alt lies ~270 nats above
    null, past the 104 nats by which f32's smallest subnormal trails 1, so
    one power of two for both would flush the null R loop to 0 (a NEG
    null).  The R loop keeps its own exponent."""
    _, pprofs, *_ = _case([100], 60, 100, ["A"], peak=0.9)
    cons = consensus(pprofs[0])
    reads = [cons, cons[:150], "ACGTA", ""]
    _, _, block, blk, eidx, slen = _case([100, 40], 60, 100, reads,
                                         peak=0.9)
    palt, pnull = vc.scores_plain(blk, torch.from_numpy(eidx),
                                  torch.from_numpy(slen), semiring="logsumexp")
    assert float(palt[0, 0] - pnull[0, 0]) > 200
    _check(blk, block, eidx, slen, True, False)


@pytest.mark.parametrize("mh,h3", [(False, False), (False, True),
                                   (True, False)])
def test_two_copies_of_a_strong_domain(mh, h3):
    """Reads of two copies of a peaked profile's consensus (equal, the
    first weaker, the first stronger, and apart): each copy scores ~100
    nats over the null, so the remains of the first copy's paths sit
    beyond f32's range above a fresh start from N at the second.  Under
    multi_hits = false only N starts the second hit, and one exponent per
    position flushed it to 0 (alt off by ln 2 for equal copies, by the
    difference of their scores otherwise).  The node groups and N keep
    exponents of their own."""
    _, pprofs, *_ = _case([40], 60, 40, ["A"], peak=0.9)
    cons = consensus(pprofs[0])
    rng = np.random.default_rng(0)
    weak = list(cons)  # a ninth of its codons redrawn at random
    for j in rng.choice(len(cons) // 3, len(cons) // 9, replace=False):
        weak[3 * j: 3 * j + 3] = rng.choice(list("ACGT"), 3)
    weak = "".join(weak)
    reads = [cons + cons, weak + cons, cons + weak,
             cons + "ACGTTGCA" * 5 + cons]
    jprofs, _, block, blk, eidx, slen = _case([40, 12], 60, 40, reads,
                                              peak=0.9)
    alt = _check(blk, block, eidx, slen, mh, h3)
    for si, r in enumerate(reads):
        ref = vr.forward_alt(jprofs[0], DNA.encode(r), mh, h3)
        assert alt[si, 0].item() == pytest.approx(ref, abs=2e-4)
    single = vr.forward_alt(jprofs[0], DNA.encode(cons), mh, h3)
    null = vr.forward_null(jprofs[0], DNA.encode(cons), mh, h3)
    assert single - null > 90


def test_600nt_read_against_f64_oracle():
    """A 600-nt read (chip_smoke.py's longest) and a 255-nt one against
    K = 129 and 60: the scaled arithmetic stays within 2e-4 of the JAX
    package's f64 oracle at |score| ~ 880, where the log-space plain
    version is off by up to 1.2e-3 (each logaddexp rounds to f32's step
    at that magnitude, 6e-5, and the rounding accumulates)."""
    rng = np.random.default_rng(7)
    reads = ["".join(rng.choice(list("ACGT"), n)) for n in (600, 255)]
    jprofs, _, block, blk, eidx, slen = _case([129, 60], 300, 129, reads)
    alt, null = forward_scaled(blk, torch.from_numpy(eidx),
                               torch.from_numpy(slen))
    for si, r in enumerate(reads):
        for bi, prof in enumerate(jprofs):
            enc = DNA.encode(r)
            assert alt[si, bi].item() == pytest.approx(
                vr.forward_alt(prof, enc), abs=2e-4)
            assert null[si, bi].item() == pytest.approx(
                vr.forward_null(prof, enc), abs=2e-4)
