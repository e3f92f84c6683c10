"""Pass 2's DP, array by array: the port's plain version against the JAX
package's, and a CPU mirror of the Hopper kernel against the plain
version, on the CPU.

- ``trace_dp`` (deciphon_tpu_torch/ops/viterbi_trace.py) returns the
  same ten backpointer arrays as deciphon_tpu.ops.viterbi_trace.
  _trace_scan_batch, bit for bit, on every row a walk can read (rows <
  seq_len): all four flag pairs, base 4, 5 and 6 tables, dead DD links,
  a profile of identical flat nodes that forces ties, chunks of 1, 3
  and 5 hits (a row each, none a copy) and an empty read beside
  others.
- The kernel's packing (``pack_chunk``, the plan table ``trace_plan``
  for every width, the output buffer's layout) is checked without a
  card, and ``kernel_mirror``, a numpy copy of csrc/traceback.cu's
  order of operations (ring slots with node k - 1 in column k, the
  candidate lists as trees of contiguous runs, the thread/warp prefix
  scan with the warps' table entries, the k - 1 / k - 2 neighbours from
  the thread before, the lowest-index E reduction, the specials one
  lookback a lane), equals ``trace_dp`` bit for bit on every row,
  padding rows included, under each plan kind (CTA, cluster).
- ``viterbi_alt_batch`` and ``trace_scan`` run ``trace_dp`` on the CPU
  and never reach the kernel's wrapper; on a CUDA device a failing
  build raises and ``trace_dp`` is not called.
- A scan's pass 2 through ``trace_scan`` gives the hits of the
  per-group path; its kernel branch, with ``kernel_mirror`` in the
  kernel's place, queues one launch per chunk into one buffer before
  one copy to the host.
The kernel itself runs only on the card (chip_smoke.py phases 2-3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deciphon_tpu.models import profile as jprofile
from deciphon_tpu.ops import viterbi_jax as vj
from deciphon_tpu.ops import viterbi_trace as jtr
from deciphon_tpu_torch.models import profile as pprofile
from deciphon_tpu_torch.models.alphabet import encode_extended
from deciphon_tpu_torch.ops import viterbi_trace as ptr


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLAGS = [(True, False), (False, False), (True, True), (False, True)]


def dead_dd(p, at):
    """``p`` with -inf D->D links into the nodes ``at``."""
    from dataclasses import replace

    dd = p.dd_in.copy()
    dd[list(at)] = -np.inf
    return replace(p, dd_in=dd)


def tie_profile(mod, K):
    """K identical nodes with flat amino emissions and flat transition
    rows, built by ``mod`` (either package's models.profile): equal
    candidates across lengths, origins and nodes."""
    flat = np.full(20, -np.log(20.0))
    b = mod.ProteinModelBuilder(mod.ProteinCfg(), null_lprobs=flat)
    b.setup(K)
    for i in range(K + 1):
        row = np.full(7, -np.log(7.0))
        if i == 0:
            row[mod.TRANS_DD] = mod.LOG0
        if i == K:
            row[mod.TRANS_MD] = row[mod.TRANS_DD] = mod.LOG0
        finite = np.isfinite(row)
        row[finite] = -np.log(finite.sum())
        b.add_trans(row)
        if i < K:
            b.add_node(flat, "-")
    return b.finalize(accession=f"ties-{K}")


def hits(case: str):
    """(JAX profiles, port profiles, reads, codes) of one case; reads are
    strings over ACGT and the case's IUPAC codes."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "ties":
        return ([tie_profile(jprofile, 12)], [tie_profile(pprofile, 12)],
                ["ACGTACGTACGTACGTAAAACCCGGGTTTACGTACG"], ())
    n, codes = {"flags": (3, ()), "base5": (5, ("N",)),
                "base6": (5, ("N", "R")), "empty": (3, ()),
                "wide": (3, ())}[case]
    jps, pps, reads = [], [], []
    for j in range(n):
        k = int(rng.integers(70, 100) if case == "wide"
                else rng.integers(4, 13))
        jp = jprofile.sample_profile(40 + j, k)
        pp = pprofile.sample_profile(40 + j, k)
        if j == 1:  # two dead D->D links inside the core
            jp, pp = dead_dd(jp, (1, k - 2)), dead_dd(pp, (1, k - 2))
        jps.append(jp)
        pps.append(pp)
        r = list(rng.choice(list("ACGT"), int(rng.integers(20, 60))))
        if codes:
            r[j % 5] = codes[0]
            r[len(r) // 2] = codes[-1]
        reads.append("".join(r))
    if case == "empty":
        reads[1] = ""
    return jps, pps, reads, codes


CASES = [("flags", mh, h3) for mh, h3 in FLAGS] + [
    ("base5", True, False), ("base6", False, True), ("ties", True, False),
    ("empty", True, False), ("wide", False, True),
]


def encoded(case):
    """(JAX profiles, port profiles, encoded reads, codes, kpad) of one
    case: kpad three nodes past the widest core (padding nodes too)."""
    jps, pps, reads, codes = hits(case)
    encs = []
    for r in reads:
        enc, got = encode_extended(r) if r else (np.zeros(0, np.int8), ())
        assert got in (codes, ())
        encs.append(enc)
    return jps, pps, encs, codes, max(p.core_size for p in pps) + 3


def chunk(case):
    """(H, port block, JAX block, eidx, lens) of the case's one chunk."""
    jps, pps, encs, codes, kpad = encoded(case)
    ((block, eidx, lens),) = ptr.chunks(pps, encs, kpad, codes or None)
    jblock = vj.build_profile_block(jps, kpad=kpad, codes=codes or None)
    for name in block._fields:
        np.testing.assert_array_equal(getattr(block, name),
                                      getattr(jblock, name), err_msg=name)
    return len(pps), block, jblock, eidx, lens


def packed(case, multi_hits=True, hmmer3_compat=False):
    """The case's one chunk in the kernel's layout on the CPU
    (``pack_chunk``, the card route's tables)."""
    _, pps, encs, codes, kpad = encoded(case)
    ((chunk_p, eidx, lens),) = ptr.chunk_reads(pps, encs, codes or None)
    return ptr.pack_chunk(chunk_p, eidx, lens, kpad, codes, multi_hits,
                          hmmer3_compat, "cpu")


def jax_specials(seq_len, multi_hits, hmmer3_compat, dtype=torch.float32):
    """The JAX package's specials as torch tensors (its logs run through
    XLA's, which differ from torch's in the last bit for some read
    lengths)."""
    xt = vj._specials(jnp.asarray(seq_len.numpy()), multi_hits,
                      hmmer3_compat)
    return {k: v if isinstance(v, float) else torch.from_numpy(np.array(v))
            for k, v in xt.items()}


@pytest.mark.parametrize("case,mh,h3", CASES)
def test_trace_dp_arrays_equal_jax(case, mh, h3, monkeypatch):
    """Every backpointer array and VT of trace_dp equal the JAX DP's,
    rows < seq_len of every hit: bit for bit when both take the
    same specials (the JAX package's, patched into trace_dp); with the
    port's own specials the nine code arrays stay equal and VT moves by
    the specials' last bit at most (1e-6 relative)."""
    H, block, jblock, eidx, lens = chunk(case)
    assert len(lens) == H
    _, _, jys = jtr._trace_scan_batch(
        tuple(jblock), jnp.asarray(eidx), jnp.asarray(lens), mh, h3)
    assert set(ptr.YS) <= set(jys)
    _, own = ptr.trace_dp(block, eidx, lens, mh, h3)
    monkeypatch.setattr(ptr, "specials", jax_specials)
    _, ys = ptr.trace_dp(block, eidx, lens, mh, h3)
    for k in ptr.YS:
        jk = np.asarray(jys[k])
        for h, L in enumerate(lens):
            np.testing.assert_array_equal(
                ys[k][:L, h], jk[h, :L], err_msg=f"{k}, hit {h}")
            if k == "VT":
                np.testing.assert_allclose(own[k][:L, h], jk[h, :L],
                                           rtol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(
                    own[k][:L, h], jk[h, :L], err_msg=f"{k}, hit {h}")
    if case == "ties":  # the profile does force ties among live values
        assert live_ties(monkeypatch, block, eidx, lens, mh, h3) > 0


def live_ties(monkeypatch, block, eidx, lens, mh, h3) -> int:
    """argmaxes of trace_dp whose maximum is live (above NEG / 2) and
    reached by more than one candidate."""
    real = torch.argmax
    n = [0]

    def counting(x, dim=None, *a, **k):
        m = x.amax(dim, keepdim=True)
        n[0] += int((((x == m).sum(dim) > 1)
                     & (m.squeeze(dim) > ptr.NEG / 2)).sum())
        return real(x, dim, *a, **k)

    monkeypatch.setattr(torch, "argmax", counting)
    ptr.trace_dp(block, eidx, lens, mh, h3)
    monkeypatch.setattr(torch, "argmax", real)
    return n[0]


def mirror_plan(kind: str, npt: int, K: int, C: int = 2) -> ptr.TracePlan:
    """A plan of ``kind`` at ``npt`` nodes a thread for width K, with as
    many warps as K needs (a cluster of C CTAs: per CTA, over K / C
    nodes); kernel_mirror takes any npt, the kernel only its
    instantiations."""
    C = 1 if kind == "cta" else C
    warps = -(-(-(-K // C)) // (32 * npt))
    return ptr.TracePlan(kind, npt, warps, C, 32 * warps, 0)


def kernel_mirror(pk: ptr.TracePack, plan: ptr.TracePlan) -> dict:
    """numpy copy of csrc/traceback.cu's order of operations on a
    ``pack_chunk`` chunk (CPU tensors) under ``plan``: ys as ``trace_dp``
    returns them.  The nodes split over threads (npt each), warps and
    the CTAs of a cluster as the plan splits them: ring slots by
    position % 5 with node k - 1 in column k, the candidate lists as the
    kernel's trees of contiguous runs (a later run wins only when
    strictly greater: lookbacks 2..5 first, then lookback 1's (M, (I,
    D)) and last its B origin, the one candidate that needs the position
    before's VB), the D-chain as thread prefixes, a warp scan
    (shfl_up) and the warp totals before each warp, the k - 1 and k - 2
    neighbours of a and b from the thread before (a shuffle, or the
    previous warp's table entries), E as thread joins, a warp butterfly
    and the warps' winners in order, and the N, J, C specials one
    lookback a lane joined by an xor butterfly over 8 lanes."""
    f32 = np.float32
    NEG, NINF = f32(-1e30), f32(-np.inf)
    BIG = 2 ** 31 - 1
    fmT, fin, planes, eidx, sp = (
        x.numpy() for x in (pk.fmT, pk.fin, pk.planes, pk.eidx, pk.sp))
    EJ, EC = f32(pk.EJ), f32(pk.EC)
    H, _, K = fmT.shape
    Lmax = eidx.shape[1]
    NPT, NT, C = plan.npt, plan.threads, plan.cluster
    if plan.kind == "cta":
        assert C == 1 and (NT - 32) * NPT < K <= NT * NPT
    else:
        assert 2 <= C <= ptr.MAX_CLUSTER
        assert (C - 1) * NT * NPT < K <= C * NT * NPT
    T = NT * C  # threads of a hit, CTA by CTA
    W = T // 32  # its warps: the cross-warp tables' entries
    N = T * NPT
    node = np.arange(N).reshape(T, NPT)  # thread t's nodes
    k0 = node[:, 0]
    lane = np.arange(T) % 32
    warp = np.arange(T) // 32
    live = node < K
    ys = {k: np.zeros((Lmax, H, K), dt) for k, dt in (
        ("bpM", np.int8), ("bpI", np.int8), ("dD", np.bool_))}
    for k in ("bpE", "bpN", "bpJ", "bpC", "bpB", "bpT"):
        ys[k] = np.zeros((Lmax, H), np.int32)
    ys["VT"] = np.zeros((Lmax, H), f32)

    def first_max(v, c, v2, c2):
        take = v2 > v
        return np.where(take, v2, v), np.where(take, c2, c)

    def arg_join(v, i, v2, i2):
        take = (v2 > v) | ((v2 == v) & (i2 < i))
        return np.where(take, v2, v), np.where(take, i2, i)

    def up(x, o=1):  # __shfl_up_sync within each warp
        y = x.reshape(-1, 32)
        z = np.concatenate([y[:, :o], y[:, :-o]], 1)
        return z.reshape(x.shape)

    def nodes(row):  # a row over the nodes, NEG past K
        out = np.full(N, NEG, f32)
        out[:K] = row
        return out

    for h in range(H):
        (entry, mm, im, dm, mi, ii, mdn, cddn, cdd) = (
            nodes(r) for r in planes[h])
        # M, I, D by slot: column c is node c - 1, column 0 NEG
        ring = np.full((3, 5, N + 1), NEG, f32)
        NN, NB = sp[h]
        rB = np.array([NB] + [NEG] * 4, f32)  # by slot
        sN, sJ, sC, sE = (np.full(5, NEG, f32) for _ in range(4))  # lanes
        for pos in range(Lmax):
            i = pos + 1
            idx = eidx[h, pos]
            emi, emn = fin[h, 0, idx], fin[h, 1, idx]
            # lookbacks 2..5 (computed while the position before settles)
            for l in range(1, 5):
                slot = (i - 1 - l) % 5
                em = nodes(fmT[h, idx[l]])
                m, iv, d = ring[0, slot], ring[1, slot], ring[2, slot]
                v, c = (rB[slot] + entry) + em, np.full(N, 4 * l)
                v, c = first_max(v, c, (m[:-1] + mm) + em, 4 * l + 1)
                w, cw = (iv[:-1] + im) + em, np.full(N, 4 * l + 2)
                w, cw = first_max(w, cw, (d[:-1] + dm) + em, 4 * l + 3)
                v, c = first_max(v, c, w, cw)
                u, cu = (m[1:] + mi) + emi[l], np.full(N, 2 * l)
                u, cu = first_max(u, cu, (iv[1:] + ii) + emi[l], 2 * l + 1)
                if l == 1:
                    pM, pcM, pI, pcI = v, c, u, cu
                else:
                    pM, pcM = first_max(pM, pcM, v, c)
                    pI, pcI = first_max(pI, pcI, u, cu)
            # lookback 1: (M, (I, D)), the rest, then B (index 0) first
            slot = (i - 1) % 5
            em = nodes(fmT[h, idx[0]])
            m, iv, d = ring[0, slot], ring[1, slot], ring[2, slot]
            v, c = (m[:-1] + mm) + em, np.full(N, 1)
            w, cw = (iv[:-1] + im) + em, np.full(N, 2)
            w, cw = first_max(w, cw, (d[:-1] + dm) + em, 3)
            v, c = first_max(v, c, w, cw)
            v, c = first_max(v, c, pM, pcM)
            VM, cm = first_max((rB[slot] + entry) + em, np.full(N, 0), v, c)
            VI, ci = first_max((m[1:] + mi) + emi[0], np.full(N, 0),
                               (iv[1:] + ii) + emi[0], 1)
            VI, ci = first_max(VI, ci, pI, pcI)
            ys["bpM"][pos, h], ys["bpI"][pos, h] = cm[:K], ci[:K]
            # D-chain: thread prefixes, warp scan, the warps before
            av = np.where(live, (VM.reshape(T, NPT) + mdn.reshape(T, NPT))
                          - cddn.reshape(T, NPT), NINF)
            pre = np.maximum.accumulate(av, axis=1)
            x = pre[:, -1].copy()
            o = 1
            while o < 32:
                x = np.where(lane >= o, np.maximum(x, up(x, o)), x)
                o *= 2
            excl = np.where(lane == 0, NINF, up(x))
            q = np.maximum(excl, pre[:, NPT - 2]) if NPT >= 2 else excl
            q_up, a_up = up(q), up(av[:, -1])
            tot = x[31::32]
            before = np.concatenate([[NINF], np.maximum.accumulate(tot)])
            before2 = np.concatenate([[NINF], before[:-1]])
            first = (lane == 0) & (warp > 0)
            q_up = np.where(first, q[np.maximum(32 * warp - 1, 0)], q_up)
            a_up = np.where(first, av[np.maximum(32 * warp - 1, 0), -1],
                            a_up)
            bw, bw2 = before[warp], before2[warp]
            E = np.maximum(excl, bw)
            b_m1 = np.where(k0 == 0, NEG, E)
            b_m2 = np.where(k0 < 2, NEG,
                            np.maximum(q_up, np.where(lane == 0, bw2, bw)))
            a_m1 = np.where(k0 == 0, NEG, a_up)
            b = np.maximum(E[:, None], pre)
            bm1 = np.concatenate([b_m1[:, None], b[:, :-1]], 1)
            VD = np.maximum(cdd.reshape(T, NPT) + bm1, NEG)
            am1 = np.concatenate([a_m1[:, None], av[:, :-1]], 1)
            bm2 = np.concatenate([b_m2[:, None], b_m1[:, None], b], 1)
            dd = am1 < bm2[:, :NPT]
            ys["dD"][pos, h] = dd.reshape(-1)[:K]
            VD = VD.reshape(-1)
            # E: each thread its M then D candidates, a warp butterfly,
            # then the warps' winners in order
            ev, eb = np.full(T, NINF, f32), np.full(T, BIG, np.int64)
            for n in range(NPT):
                k = node[:, n]
                ok = k < K
                kk = np.minimum(k, K - 1)
                vm = np.where(ok, VM[kk], NINF)
                vd = np.where(ok, np.where(kk == 0, NEG, VD[kk]), NINF)
                ev, eb = arg_join(ev, eb, vm, np.where(ok, kk, BIG))
                ev, eb = arg_join(ev, eb, vd, np.where(ok, K + kk, BIG))
            for o in (16, 8, 4, 2, 1):
                src = (np.arange(T) // 32) * 32 + (lane ^ o)
                ev, eb = arg_join(ev, eb, ev[src], eb[src])
            VE, bE = ev[0], eb[0]
            for w in range(1, W):
                VE, bE = arg_join(VE, bE, ev[32 * w], eb[32 * w])
            cur = i % 5
            ring[0, cur, 1:], ring[1, cur, 1:], ring[2, cur, 1:] = VM, VI, VD
            # N, J, C: lane l < 5 its lookback, xor butterfly over 8 lanes
            ls = np.arange(8)
            lb = np.minimum(ls, 4)
            em = emn[lb]
            sS = np.where(ls == i - 1, f32(0), NEG)
            best = {}
            for name, c0, c1 in (
                ("N", (sS + NN) + em, (sN[lb] + NN) + em),
                ("J", ((sE[lb] + EJ) + NN) + em, (sJ[lb] + NN) + em),
                ("C", ((sE[lb] + EC) + NN) + em, (sC[lb] + NN) + em),
            ):
                v, c = first_max(c0, 2 * lb, c1, 2 * lb + 1)
                v = np.where(ls >= 5, NINF, v)
                c = np.where(ls >= 5, BIG, c)
                for o in (4, 2, 1):
                    v, c = arg_join(v, c, v[ls ^ o], c[ls ^ o])
                best[name] = (f32(v[0]), int(c[0]))
            VNn, VJn, VCn = (best[n][0] for n in "NJC")
            VBn, cB = NEG, 0
            for code, c in ((1, VNn + NB), (2, (VE + EJ) + NB),
                            (3, VJn + NB)):
                if c > VBn:
                    VBn, cB = c, code
            VTn, cT = (VE + EC) + NB, 0
            if VCn + NB > VTn:
                VTn, cT = VCn + NB, 1
            for k, v in (("bpE", bE), ("bpN", best["N"][1]),
                         ("bpJ", best["J"][1]), ("bpC", best["C"][1]),
                         ("bpB", cB), ("bpT", cT), ("VT", VTn)):
                ys[k][pos, h] = v
            rB[cur] = VBn
            for r, v in ((sN, VNn), (sJ, VJn), (sC, VCn), (sE, VE)):
                r[1:] = r[:-1].copy()
                r[0] = v
    return ys


def mirror_plans(K: int) -> list:
    """The plans kernel_mirror runs at width K: trace_plan's, one warp
    of ceil(K / 32) nodes a lane, and every kind at 1 and 2 nodes a
    thread where K gives it more than one warp (clusters of 2 and 4 CTAs
    where the last CTA holds a node)."""
    plans = [ptr.trace_plan(K), mirror_plan("cta", -(-K // 32), K)]
    for npt in (1, 2):
        if K > 32 * npt:
            plans.append(mirror_plan("cta", npt, K))
        for C in (2, 4):
            p = mirror_plan("cluster", npt, K, C)
            if (C - 1) * p.threads * npt < K:
                plans.append(p)
    return plans


@pytest.mark.parametrize("case,mh,h3", CASES)
def test_kernel_mirror_equals_trace_dp(case, mh, h3):
    """The kernel's order of operations gives trace_dp's arrays bit for
    bit, every row (past seq_len too: the kernel runs every hit to the
    chunk's Lmax, as trace_dp does), under every plan kind: a CTA of one
    warp or several, and a cluster whose CTAs split the nodes (the
    "wide" case gives several warps and both CTAs)."""
    _, block, _, eidx, lens = chunk(case)
    _, ys = ptr.trace_dp(block, eidx, lens, mh, h3)
    pk = packed(case, mh, h3)
    K = pk.fmT.shape[2]
    plans = mirror_plans(K)
    if case == "wide":
        assert {p.kind for p in plans} == set(ptr.TRACE_KINDS)
        assert max(p.warps * p.cluster for p in plans) > 2
    for plan in plans:
        got = kernel_mirror(pk, plan)
        for k in ptr.YS:
            np.testing.assert_array_equal(got[k], ys[k].astype(got[k].dtype),
                                          err_msg=f"{k}, plan {plan}")


def test_pack_trace_layout():
    """Transposed tables (the host block's), stacked planes, the
    D-chain's precomputed terms (the same torch calls as trace_dp's),
    dtypes and shapes."""
    _, block, _, eidx, lens = chunk("flags")
    pk = packed("flags")
    H, K, ntab = block.fm.shape
    Lmax = int(lens.max())
    assert pk.fmT.shape == (H, ntab, K) and pk.fmT.is_contiguous()
    np.testing.assert_array_equal(pk.fmT.numpy(), block.fm.transpose(0, 2, 1))
    np.testing.assert_array_equal(pk.fin.numpy(),
                                  np.stack([block.fi, block.fn], 1))
    assert pk.eidx.dtype == torch.int32 and pk.eidx.shape == (H, Lmax, 5)
    np.testing.assert_array_equal(pk.eidx.numpy(), eidx[:, :Lmax])
    assert pk.planes.dtype == torch.float32
    assert pk.planes.shape == (H, len(ptr.TRACE_PLANES), K)
    planes = dict(zip(ptr.TRACE_PLANES, pk.planes.unbind(1)))
    for n in ("entry", "mm_in", "im_in", "dm_in", "mi", "ii"):
        np.testing.assert_array_equal(planes[n].numpy(), getattr(block, n))
    neg1 = np.full((H, 1), ptr.NEG, np.float32)
    np.testing.assert_array_equal(
        planes["md_next"].numpy(),
        np.concatenate([block.md_in[:, 1:], neg1], 1))
    dd = torch.clamp_min(torch.from_numpy(block.dd_in), ptr.NEG / 1e6)
    dd[:, 0] = 0.0
    cdd = torch.cumsum(dd, 1)
    np.testing.assert_array_equal(planes["cdd"].numpy(), cdd.numpy())
    np.testing.assert_allclose(planes["cdd"].numpy(), np.cumsum(
        dd.numpy().astype(np.float64), 1), rtol=1e-6)
    np.testing.assert_array_equal(
        planes["cdd_next"].numpy(),
        np.concatenate([cdd[:, 1:], cdd[:, -1:]], 1))
    from deciphon_tpu_torch.ops.viterbi_torch import specials

    xt = specials(torch.from_numpy(lens), True, False)
    np.testing.assert_array_equal(pk.sp.numpy(),
                                  torch.stack([xt["NN"], xt["NB"]], 1))
    assert (pk.EJ, pk.EC) == (xt["EJ"], xt["EC"])


def test_trace_plan_fits_every_width():
    """Every width 1..4096 gets exactly one plan, TRACE_TABLE's row, that
    an instantiation of the kernel takes (the entry point's checks,
    csrc/traceback.cu launch): a CTA of whole warps with no idle warp,
    or a cluster of 2 or 4 CTAs whose last CTA holds real nodes; the
    dynamic shared memory (rings and cross-warp tables) within the
    card's opt-in and the threads within the __launch_bounds__.  The
    kernel's instantiations are the table's, and every alternative of
    chip_smoke.py's sweep is one."""
    import re
    from pathlib import Path

    import chip_smoke

    src = (Path(ptr.__file__).parents[1] / "csrc" / "traceback.cu").read_text()
    body = src[src.index("#define DCP_TRACE_KERNELS"):]
    body = body[:body.index("\n\n")]
    kinds = {"CTA": "cta", "CLUS": "cluster"}
    assert tuple((kinds[k], int(n)) for k, n in re.findall(
        r"X\((\w+), (\d+)\)", body)) == ptr.TRACE_KERNELS
    assert re.search(r"enum \{ CTA, CLUS \};", src)  # TRACE_KINDS order
    rows = {}
    for K in range(1, ptr.MAX_K + 1):
        p = ptr.trace_plan(K)
        top, kind, npt = next(r for r in ptr.TRACE_TABLE if K <= r[0])
        rows.setdefault(top, []).append(K)
        assert (p.kind, p.npt) == (kind, npt)
        NT = 32 * p.warps
        rings = 4 * 15 * (NT * p.npt + 1)
        if p.kind == "cta":
            assert p.cluster == 1 and p.threads == NT
            assert (NT - 32) * p.npt < K <= NT * p.npt
            assert p.smem == rings + ptr.TABLE_BYTES
        else:
            C = p.cluster
            assert p.threads == NT
            assert C in (2, 4) and C <= ptr.MAX_CLUSTER
            assert (C - 1) * NT * p.npt < K <= C * NT * p.npt
            assert (NT - 32) * p.npt < -(-K // C)
            assert C == 2 or (C // 2) * ptr.CTA_THREADS * p.npt < K
            assert p.smem == rings + ptr.TABLE_BYTES
        assert p.threads <= ptr.CTA_THREADS and p.smem <= ptr.SMEM_MAX
    # each row of the table holds the widths above the row before
    tops = [r[0] for r in ptr.TRACE_TABLE]
    assert [(ks[0], ks[-1]) for ks in rows.values()] == list(
        zip([1] + [t + 1 for t in tops[:-1]], tops))
    for K, _, _, alts in chip_smoke.TRACE_SWEEP:
        for kind, npt in alts:
            assert ptr._plan(kind, npt, K)[:2] != ptr.trace_plan(K)[:2]
    for bad in (0, 4097):
        with pytest.raises(ValueError):
            ptr.trace_plan(bad)
    with pytest.raises(ValueError):  # no instantiation: 4 nodes a thread
        ptr._plan("cta", 4, 384)
    with pytest.raises(ValueError):  # 18 warps > CTA_THREADS
        ptr._plan("cta", 2, 1100)


def test_output_buffer_round_trip():
    """The kernel's one output buffer: ys written at ``_layout``'s
    offsets come back from TraceOut.host() equal, with trace_dp's
    shapes."""
    _, block, _, eidx, lens = chunk("flags")
    _, ys = ptr.trace_dp(block, eidx, lens, True, False)
    L, H, K = ys["bpM"].shape
    views, nbytes = ptr._layout(L, H, K)
    raw = np.zeros(nbytes, np.uint8)
    for k, (off, dt, shape) in views.items():
        assert off % 16 == 0 and shape == ys[k].shape
        b = np.ascontiguousarray(ys[k].astype(dt)).view(np.uint8).ravel()
        raw[off:off + b.size] = b
    got = ptr.TraceOut(torch.from_numpy(raw), views).host()
    for k in ptr.YS:
        assert got[k].dtype == views[k][1]
        np.testing.assert_array_equal(got[k], ys[k])


def test_cpu_never_reaches_the_kernel(monkeypatch):
    """On the CPU viterbi_alt_batch and a scan's pass 2 (trace_scan) run
    trace_dp, one call per chunk, and never the kernel's wrapper."""
    def boom(*a, **k):
        raise AssertionError("kernel wrapper called on the CPU")

    calls = []
    real = ptr.trace_dp
    monkeypatch.setattr(ptr, "launch_trace", boom)
    monkeypatch.setattr(ptr, "_launch", boom)
    monkeypatch.setattr(
        ptr, "trace_dp", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, pps, reads, _ = hits("flags")
    encs = [encode_extended(r)[0] for r in reads]
    res = ptr.viterbi_alt_batch(pps, encs, device="cpu")
    assert len(res) == len(reads) and calls == [1]
    (got,) = ptr.trace_scan([(pps, encs, None, ())], device="cpu")
    assert got == res and calls == [1, 1]


def test_cuda_build_failure_raises(monkeypatch):
    """On a CUDA device a failing kernel build raises, in
    viterbi_alt_batch and in trace_scan, before anything is uploaded;
    trace_dp is never the fallback."""
    from deciphon_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    def no_plain(*a, **k):
        raise AssertionError("trace_dp called on a CUDA device")

    # a machine with a card but no compiler: the device check passes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "library", no_nvcc)
    monkeypatch.setattr(ptr, "trace_dp", no_plain)
    _, pps, reads, _ = hits("flags")
    encs = [encode_extended(r)[0] for r in reads]
    with pytest.raises(RuntimeError, match="nvcc"):
        ptr.viterbi_alt_batch(pps, encs, device="cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        ptr.trace_scan([(pps, encs, None, ())], device="cuda")


def test_launch_refuses_a_cpu_chunk():
    """The kernel's wrapper takes only a chunk on a card; the CPU's DP is
    trace_dp."""
    pk = packed("flags")
    with pytest.raises(ValueError, match="runs on a card"):
        ptr.launch_trace(pk)


@pytest.fixture(scope="module")
def scan_db(tmp_path_factory):
    """Profiles of cores 10, 40 and 70 (three padded widths, 32, 64 and
    96), pressed by the port."""
    from deciphon_tpu_torch.db.format import TensorDB, write_db
    from deciphon_tpu_torch.models.h3reader import press_file
    from deciphon_tpu_torch.models.h3writer import random_h3, write_h3

    tmp = tmp_path_factory.mktemp("trace_scan")
    hmm = tmp / "synth.hmm"
    with open(hmm, "w") as fp:
        write_h3(fp, [random_h3(s, k, peak=0.9)
                      for s, k in [(11, 10), (12, 40), (13, 70)]])
    dbp = str(tmp / "synth.dtp")
    write_db(dbp, press_file(str(hmm)))
    return TensorDB.load(dbp)


def scan_reads(db):
    """Consensus reads of each profile, two of them with an N, a second
    read of profile 1's consensus and a random read: survivors in
    (width, class) groups of both classes, one group of two."""
    from deciphon_tpu_torch.models.alphabet import STANDARD_CODE
    from deciphon_tpu_torch.ops.scan_engine import SeqRecord

    def cons(j):
        p = db.profile(j)
        return "".join(STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
                       for b in map(int, np.argmax(p.match_codonp, 1)))
    reads = [cons(0), cons(1), cons(2)]
    reads += [r[:7] + "N" + r[8:] for r in reads[1:]] + [reads[1][3:]]
    reads.append("".join(np.random.default_rng(5).choice(list("ACGT"), 90)))
    return [SeqRecord(j + 1, f"r{j}", r) for j, r in enumerate(reads)]


def per_group_hits(engine, seqs):
    """Pass 2 as the engine ran it before trace_scan: one
    viterbi_alt_batch per (width, class) group, in trace_groups' order,
    each hit's (read, profile, path, match string)."""
    from deciphon_tpu_torch.models import codec

    encoded, _ = engine.encode(seqs)
    out = []
    for (kpad, codes), items in engine.trace_groups(
            engine.last_survivors).items():
        profs = [engine.db.profile(gi) for _, gi, *_ in items]
        res = ptr.viterbi_alt_batch(
            profs, [encoded[si] for si, *_ in items],
            multi_hits=engine.params.multi_hits,
            hmmer3_compat=engine.params.hmmer3_compat, kpad=kpad,
            device=engine.device, codes=codes)
        for (si, gi, *_), prof, r in zip(items, profs, res):
            out.append((si, gi, r.path, codec.render_match(
                codec.match_steps(prof, seqs[si].data, r.path))))
    return sorted(out, key=lambda x: x[:2])


def test_trace_scan_equals_per_group_path(scan_db):
    """A CPU scan whose pass 2 queues every group through trace_scan
    gives the hits (paths and match strings) of the per-group path,
    with survivors in several (width, class) groups."""
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine

    engine = ScanEngine(scan_db, device="cpu")
    seqs = scan_reads(scan_db)
    waits = ptr.HOST_WAITS["pass2"]
    hits_ = engine.scan(seqs)
    assert ptr.HOST_WAITS["pass2"] == waits + 1
    groups = engine.trace_groups(engine.last_survivors)
    assert len(groups) >= 4 and {c for _, c in groups} == {(), ("N",)}
    assert len({k for k, _ in groups}) == 3
    got = sorted(((h.seq_idx, h.profile_idx, h.path, h.match)
                  for h in hits_), key=lambda x: x[:2])
    assert got == per_group_hits(engine, seqs)


def test_trace_scan_queues_every_chunk_before_one_wait(scan_db,
                                                       monkeypatch):
    """trace_scan's kernel branch, run on the CPU with kernel_mirror in
    the kernel's place: one launch per chunk of every group (chunks of
    one hit here, so the group of two is two chunks), each into its own
    slice of the scan's one buffer, all launches before the one copy to
    the host and before any walk; the hits equal the per-group path's."""
    from deciphon_tpu_torch.ops import _build
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine

    log = []

    def mirror_launch(pk, out=None):
        views = out.views
        assert views["bpM"][2] == (pk.eidx.shape[1], *pk.fmT.shape[::2])
        ys = kernel_mirror(pk, ptr.trace_plan(pk.fmT.shape[2]))
        raw = out.buf.numpy()
        for k, (off, dt, shape) in views.items():
            b = np.ascontiguousarray(ys[k], dtype=dt).view(np.uint8)
            raw[off:off + b.size] = b.ravel()
        ptr.LAUNCHES["traceback"] += 1
        log.append(("launch", views["bpM"][0]))
        return out

    real_walk = ptr.walk

    def logged_walk(*a, **k):
        log.append(("walk", None))
        return real_walk(*a, **k)

    engine = ScanEngine(scan_db, device="cpu")
    seqs = scan_reads(scan_db)
    want = None
    engine.scan(seqs)
    want = per_group_hits(engine, seqs)
    monkeypatch.setattr(ptr, "TRACE_BATCH", 1)
    monkeypatch.setattr(_build, "library", lambda: None)
    monkeypatch.setattr(ptr, "_on_card", lambda dev: True)
    monkeypatch.setattr(ptr, "launch_trace", mirror_launch)
    monkeypatch.setattr(ptr, "walk", logged_walk)
    monkeypatch.setattr(ptr, "trace_dp", None)  # never called
    ptr.LAUNCHES["traceback"] = 0
    waits = ptr.HOST_WAITS["pass2"]
    hits_ = engine.scan(seqs)
    groups = engine.trace_groups(engine.last_survivors)
    chunks_ = sum(len(items) for items in groups.values())
    assert chunks_ > len(groups)  # some group has two chunks
    assert ptr.LAUNCHES["traceback"] == chunks_
    assert ptr.HOST_WAITS["pass2"] == waits + 1
    kinds = [k for k, _ in log]
    assert kinds == ["launch"] * chunks_ + ["walk"] * len(hits_)
    offsets = [o for k, o in log if k == "launch"]
    assert offsets == sorted(set(offsets))  # disjoint, in order
    got = sorted(((h.seq_idx, h.profile_idx, h.path, h.match)
                  for h in hits_), key=lambda x: x[:2])
    assert got == want


def test_chunk_bytes_count_the_packed_chunk(monkeypatch):
    """``_chunk_bytes``, known before a block is built (ntab from the
    read class), is what a queued chunk holds on its device: its packed
    inputs and its outputs, for base-4 and extended tables.  Each chunk
    holds exactly its real hits, min(TRACE_BATCH, hits left)."""
    monkeypatch.setattr(ptr, "TRACE_BATCH", 2)
    for case in ("flags", "base6"):
        profs, pps, reads, codes = hits(case)
        encs = [encode_extended(r)[0] for r in reads]
        codes = codes or None
        shapes = list(ptr.chunk_shapes(pps, encs, None, codes))
        built = list(ptr.chunk_reads(pps, encs, codes))
        assert [len(lens) for _, _, lens in built] == [
            min(2, len(pps) - lo) for lo in range(0, len(pps), 2)]
        for (H, L, K, ntab), (chunk_p, eidx, lens) in zip(shapes, built,
                                                          strict=True):
            pk = ptr.pack_chunk(chunk_p, eidx, lens, None, codes, True,
                                False, "cpu")
            assert (H, ntab, K) == tuple(pk.fmT.shape)
            assert L == int(lens.max())
            held = sum(x.numel() * x.element_size() for x in pk[:5])
            assert ptr._chunk_bytes(H, L, K, ntab) == held + ptr._layout(
                L, H, K)[1]


def test_trace_scan_waits_once_per_window(scan_db, monkeypatch):
    """With QUEUE_BYTES below a chunk's bytes every chunk is a window of
    its own: trace_scan's kernel branch (kernel_mirror in the kernel's
    place, on the CPU) launches it, waits once, walks its hits, and the
    next window reuses the buffer from byte 0; the hits equal the
    per-group path's.  The plain branch gives the same hits with the
    same waits."""
    from deciphon_tpu_torch.ops import _build
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine

    log = []

    def mirror_launch(pk, out=None):
        ys = kernel_mirror(pk, ptr.trace_plan(pk.fmT.shape[2]))
        raw = out.buf.numpy()
        for k, (off, dt, shape) in out.views.items():
            b = np.ascontiguousarray(ys[k], dtype=dt).view(np.uint8)
            raw[off:off + b.size] = b.ravel()
        log.append(("launch", out.views["bpM"][0]))
        return out

    real_walk = ptr.walk

    def logged_walk(*a, **k):
        log.append(("walk", None))
        return real_walk(*a, **k)

    engine = ScanEngine(scan_db, device="cpu")
    seqs = scan_reads(scan_db)
    engine.scan(seqs)
    want = per_group_hits(engine, seqs)
    groups = engine.trace_groups(engine.last_survivors)
    sizes = [len(items) for items in groups.values()]
    monkeypatch.setattr(ptr, "QUEUE_BYTES", 1)
    monkeypatch.setattr(ptr, "walk", logged_walk)
    for card in (False, True):
        if card:
            monkeypatch.setattr(_build, "library", lambda: None)
            monkeypatch.setattr(ptr, "_on_card", lambda dev: True)
            monkeypatch.setattr(ptr, "launch_trace", mirror_launch)
            monkeypatch.setattr(ptr, "trace_dp", None)  # never called
        log.clear()
        waits = ptr.HOST_WAITS["pass2"]
        hits_ = engine.scan(seqs)
        assert ptr.HOST_WAITS["pass2"] == waits + len(sizes)
        got = sorted(((h.seq_idx, h.profile_idx, h.path, h.match)
                      for h in hits_), key=lambda x: x[:2])
        assert got == want
        if card:
            assert log == [e for n in sizes
                           for e in [("launch", 0)] + [("walk", None)] * n]
