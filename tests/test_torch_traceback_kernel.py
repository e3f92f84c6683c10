"""Pass 2's DP, array by array: the port's plain version against the JAX
package's, and a CPU mirror of the Hopper kernel against the plain
version, on the CPU.

- ``trace_dp`` (deciphon_tpu_torch/ops/viterbi_trace.py) returns the
  same ten backpointer arrays as deciphon_tpu.ops.viterbi_trace.
  _trace_scan_batch, bit for bit, on every row a walk can read (rows <
  seq_len): all four flag pairs, base 4, 5 and 6 tables, dead DD links,
  a profile of identical flat nodes that forces ties, 1, 3 and 5 hits
  (padded to 1, 4 and 8) and an empty read beside others.
- The kernel's packing (``pack_trace``, ``trace_plan``, the output
  buffer's layout) is checked without a card, and ``kernel_mirror``, a
  numpy copy of csrc/traceback.cu's order of operations (its rings with
  a sentinel column, slots, strict ``>`` over the candidates, the
  thread/warp prefix scan and lowest-index E reduction), equals
  ``trace_dp`` bit for bit on every row, padding rows included.
- ``viterbi_alt_batch`` runs ``trace_dp`` on the CPU and never reaches
  the kernel's wrapper; on a CUDA device a failing build raises and
  ``trace_dp`` is not called.
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
                "base6": (5, ("N", "R")), "empty": (3, ())}[case]
    jps, pps, reads = [], [], []
    for j in range(n):
        k = int(rng.integers(4, 13))
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
    ("empty", True, False),
]


def chunk(case):
    """(H, port block, JAX block, eidx, lens) of the case's one chunk."""
    jps, pps, reads, codes = hits(case)
    encs = []
    for r in reads:
        enc, got = encode_extended(r) if r else (np.zeros(0, np.int8), ())
        assert got in (codes, ())
        encs.append(enc)
    kpad = max(p.core_size for p in pps) + 3  # padding nodes too
    ((H, block, eidx, lens),) = ptr.chunks(pps, encs, kpad, codes or None)
    Hp = len(lens)
    jpad = jps + [jps[0]] * (Hp - H)
    jblock = vj.build_profile_block(jpad, kpad=kpad, codes=codes or None)
    for name in block._fields:
        np.testing.assert_array_equal(getattr(block, name),
                                      getattr(jblock, name), err_msg=name)
    return H, block, jblock, eidx, lens


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
    rows < seq_len of every (padded) hit: bit for bit when both take the
    same specials (the JAX package's, patched into trace_dp); with the
    port's own specials the nine code arrays stay equal and VT moves by
    the specials' last bit at most (1e-6 relative)."""
    H, block, jblock, eidx, lens = chunk(case)
    assert len(lens) == {"flags": 4, "base5": 8, "base6": 8, "ties": 1,
                         "empty": 4}[case]
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


def kernel_mirror(pk: ptr.TracePack, plan: ptr.TracePlan) -> dict:
    """numpy copy of csrc/traceback.cu's order of operations on a
    ``pack_trace`` chunk (CPU tensors): ys as ``trace_dp`` returns them."""
    f32 = np.float32
    NEG, NINF = f32(-1e30), f32(-np.inf)
    fmT, fin, planes, eidx, sp = (
        x.numpy() for x in (pk.fmT, pk.fin, pk.planes, pk.eidx, pk.sp))
    EJ, EC = f32(pk.EJ), f32(pk.EC)
    H, _, K = fmT.shape
    Lmax = eidx.shape[1]
    T, NPT = plan.threads, plan.npt
    W = T // 32
    assert T % 32 == 0 and T * NPT >= K and (T - 32) * NPT < K
    ys = {k: np.zeros((Lmax, H, K), dt) for k, dt in (
        ("bpM", np.int8), ("bpI", np.int8), ("dD", np.bool_))}
    for k in ("bpE", "bpN", "bpJ", "bpC", "bpB", "bpT"):
        ys[k] = np.zeros((Lmax, H), np.int32)
    ys["VT"] = np.zeros((Lmax, H), f32)
    node = np.arange(T * NPT).reshape(T, NPT)  # thread t's nodes
    live = node < K
    for h in range(H):
        (entry, mm, im, dm, mi, ii, md_next, cdd_next, cdd) = planes[h]
        ring = np.full((3, 5, K + 1), NEG, f32)  # column k is node k - 1
        sa = np.full(K + 2, NEG, f32)  # node k at k + 2
        sb = np.full(K + 2, NEG, f32)
        NN, NB = sp[h]
        rS = np.array([0] + [NEG] * 4, f32)
        rB = np.array([NB] + [NEG] * 4, f32)
        rN, rJ, rC, rE = (np.full(5, NEG, f32) for _ in range(4))
        for pos in range(Lmax):
            i = pos + 1
            idx = eidx[h, pos]
            emi, emn = fin[h, 0, idx], fin[h, 1, idx]
            ks = np.arange(K)
            bm = bi = None
            cm = np.zeros(K, np.int8)
            ci = np.zeros(K, np.int8)
            for l in range(5):
                slot = (i - 1 - l + 5) % 5
                em = fmT[h, idx[l]]
                cands = [(rB[l] + entry) + em,
                         (ring[0, slot, ks] + mm) + em,
                         (ring[1, slot, ks] + im) + em,
                         (ring[2, slot, ks] + dm) + em]
                for o, c in enumerate(cands):
                    if bm is None:
                        bm = c
                        continue
                    take = c > bm
                    bm = np.where(take, c, bm)
                    cm = np.where(take, 4 * l + o, cm).astype(np.int8)
                for o, c in enumerate([(ring[0, slot, ks + 1] + mi) + emi[l],
                                       (ring[1, slot, ks + 1] + ii) + emi[l]]):
                    if bi is None:
                        bi = c
                        continue
                    take = c > bi
                    bi = np.where(take, c, bi)
                    ci = np.where(take, 2 * l + o, ci).astype(np.int8)
            ys["bpM"][pos, h], ys["bpI"][pos, h] = cm, ci
            a = (bm + md_next) - cdd_next
            sa[2:] = a
            # thread prefix, warp scan of the thread totals, warps before
            av = np.full((T, NPT), NINF, f32)
            av[live] = a[node[live]]
            pre = np.maximum.accumulate(av, axis=1)
            x = pre[:, -1].reshape(W, 32)
            x = np.maximum.accumulate(x, axis=1)
            excl = np.concatenate([np.full((W, 1), NINF, f32), x[:, :-1]], 1)
            tot = x[:, -1]
            before = np.concatenate([[NINF], np.maximum.accumulate(tot)[:-1]])
            excl = np.maximum(excl, before[:, None]).reshape(T)
            b = np.maximum(excl[:, None], pre)[live]
            sb[2:] = b[np.argsort(node[live])]
            VD = np.maximum(cdd + sb[1:K + 1], NEG)
            ys["dD"][pos, h] = sa[1:K + 1] < sb[0:K]
            cur = i % 5
            ring[0, cur, 1:], ring[1, cur, 1:], ring[2, cur, 1:] = bm, bi, VD
            # E: each thread its M then D candidates, warp butterfly,
            # then the warps in order, lowest index on equal values
            ev = np.full(T, NINF, f32)
            ei = np.full(T, 2 ** 31 - 1, np.int64)

            def join(v, j, v2, j2):
                take = (v2 > v) | ((v2 == v) & (j2 < j))
                return np.where(take, v2, v), np.where(take, j2, j)

            for n in range(NPT):
                k = node[:, n]
                ok = k < K
                kk = np.minimum(k, K - 1)
                vm = np.where(ok, bm[kk], NINF)
                vd = np.where(ok, np.where(kk == 0, NEG, VD[kk]), NINF)
                ev, ei = join(ev, ei, vm, np.where(ok, kk, ei))
                ev, ei = join(ev, ei, vd, np.where(ok, K + kk, ei))
            ev, ei = ev.reshape(W, 32), ei.reshape(W, 32)
            for o in (16, 8, 4, 2, 1):
                lanes = np.arange(32) ^ o
                ev, ei = join(ev, ei, ev[:, lanes], ei[:, lanes])
            VE, bE = ev[0, 0], ei[0, 0]
            for w in range(1, W):
                VE, bE = join(VE, bE, ev[w, 0], ei[w, 0])
            # specials, as every thread computes them
            best = {}
            for name, c0, c1 in (
                ("N", (rS + NN) + emn, (rN + NN) + emn),
                ("J", ((rE + EJ) + NN) + emn, (rJ + NN) + emn),
                ("C", ((rE + EC) + NN) + emn, (rC + NN) + emn),
            ):
                v, code = c0[0], 0
                for l in range(5):
                    if l and c0[l] > v:
                        v, code = c0[l], 2 * l
                    if c1[l] > v:
                        v, code = c1[l], 2 * l + 1
                best[name] = (f32(v), code)
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
            for r, v in ((rS, NEG), (rN, VNn), (rJ, VJn), (rC, VCn),
                         (rE, VE), (rB, VBn)):
                r[1:] = r[:-1].copy()
                r[0] = v
    return ys


@pytest.mark.parametrize("case,mh,h3", CASES)
def test_kernel_mirror_equals_trace_dp(case, mh, h3):
    """The kernel's order of operations gives trace_dp's arrays bit for
    bit, every row (past seq_len too: the kernel runs every hit to the
    chunk's Lmax, as trace_dp does); several nodes a thread and several
    warps are exercised by forcing small plans."""
    _, block, _, eidx, lens = chunk(case)
    _, ys = ptr.trace_dp(block, eidx, lens, mh, h3)
    pk = ptr.pack_trace(block, eidx, lens, mh, h3, "cpu")
    K = pk.fmT.shape[2]
    for plan in (ptr.trace_plan(K), ptr.TracePlan(2, 32, 0, True),
                 ptr.TracePlan(1, 32 * -(-K // 32), 0, True)):
        if plan.threads * plan.npt < K:
            continue
        got = kernel_mirror(pk, plan)
        for k in ptr.YS:
            np.testing.assert_array_equal(got[k], ys[k].astype(got[k].dtype),
                                          err_msg=f"{k}, plan {plan}")


def test_pack_trace_layout():
    """Transposed tables, stacked planes, the D-chain's precomputed terms
    (the same torch calls as trace_dp's), dtypes and shapes."""
    _, block, _, eidx, lens = chunk("flags")
    pk = ptr.pack_trace(block, eidx, lens, True, False, "cpu")
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
    """Every width 1..4096 has a plan the entry point accepts: whole
    warps of at most 512 threads covering K with no idle warp, and the
    dynamic shared memory the kernel needs within the card's opt-in."""
    for K in range(1, 4097):
        p = ptr.trace_plan(K)
        assert p.npt in (1, 2, 4, 8)
        assert p.threads % 32 == 0 and 32 <= p.threads <= ptr.MAX_THREADS
        assert p.threads * p.npt >= K > (p.threads - 32) * p.npt
        floats = (15 * (K + 1) if p.ring_in_smem else 0) + 2 * (K + 2)
        assert p.smem == 4 * floats <= ptr.SMEM_MAX
    assert ptr.trace_plan(3072).ring_in_smem
    assert not ptr.trace_plan(4096).ring_in_smem
    with pytest.raises(ValueError):
        ptr.trace_plan(4097)


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
    """On the CPU viterbi_alt_batch runs trace_dp, one call per chunk,
    and never the kernel's wrapper."""
    def boom(*a, **k):
        raise AssertionError("kernel wrapper called on the CPU")

    calls = []
    real = ptr.trace_dp
    monkeypatch.setattr(ptr, "trace_kernel", boom)
    monkeypatch.setattr(ptr, "launch_trace", boom)
    monkeypatch.setattr(
        ptr, "trace_dp", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, pps, reads, _ = hits("flags")
    encs = [encode_extended(r)[0] for r in reads]
    res = ptr.viterbi_alt_batch(pps, encs, device="cpu")
    assert len(res) == len(reads) and calls == [1]


def test_cuda_build_failure_raises(monkeypatch):
    """On a CUDA device a failing kernel build raises; trace_dp is never
    the fallback."""
    from deciphon_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    def no_plain(*a, **k):
        raise AssertionError("trace_dp called on a CUDA device")

    monkeypatch.setattr(_build, "library", no_nvcc)
    monkeypatch.setattr(ptr, "trace_dp", no_plain)
    _, pps, reads, _ = hits("flags")
    encs = [encode_extended(r)[0] for r in reads]
    with pytest.raises(RuntimeError, match="nvcc"):
        ptr.viterbi_alt_batch(pps, encs, device="cuda")


def test_launch_refuses_a_cpu_chunk():
    """The kernel's wrapper takes only a chunk on a card; the CPU's DP is
    trace_dp."""
    _, block, _, eidx, lens = chunk("flags")
    pk = ptr.pack_trace(block, eidx, lens, True, False, "cpu")
    with pytest.raises(ValueError, match="runs on a card"):
        ptr.launch_trace(pk)
