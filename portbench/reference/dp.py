"""The plain reference's dynamic programs, in plain torch on any device.

``tables`` scores every fragment of length 1..5 for a stack of frame
states (the frameshift error model of model.TERMS).  ``Pairs`` scores
(read, profile) pairs under the codon-frame plan-7 model: Viterbi
("max") or forward ("lse"), null (R) and alt (S N B core E J C T), the
state recurrences written out as deciphon's protein model states them,
one position after another and vectorised over pairs and nodes.  With
``trace`` it keeps the first best origin of every state and walks the
best path back.  ``path_score`` scores a given path under the model.

Every quantity is computed in the ``dtype`` asked for: float64 for the
reference; a lower precision for the control.  Nothing here reads what
the program built.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import model as rm

NEG = -float("inf")


def tables(codonp: np.ndarray, q: np.ndarray, eps: float, codes: tuple,
           device, dtype=torch.float64) -> torch.Tensor:
    """[N, ntab] log P(fragment | state) over base 4 + len(codes) observed
    symbols, for states with codon log-probs [N, 64] and background
    nucleotide log-probs [N, 4]; the last row is the -inf sentinel.
    Computed in float64, returned in ``dtype``."""
    f64 = torch.float64
    mem = torch.as_tensor(rm.members(codes), dtype=f64, device=device)
    S = mem.shape[0]
    cod = torch.as_tensor(rm.CODON_NT, device=device)
    # agg[pattern, codon]: the codon agrees with each internal symbol
    agg = (mem[:, cod[:, 0]][:, None, None, :] * mem[:, cod[:, 1]][None, :, None, :]
           * mem[:, cod[:, 2]][None, None, :, :]).reshape(S**3, 64)
    p = torch.exp(torch.as_tensor(codonp, dtype=f64, device=device))
    me = p @ agg.T  # [N, S^3]
    q4 = torch.exp(torch.as_tensor(q, dtype=f64, device=device))
    qe = torch.cat([q4, torch.ones_like(q4[:, :1]), q4 @ mem[5:].T], 1)
    base = 4 + len(codes)
    offsets, sentinel = rm.layout(base)
    obs2int = np.concatenate([np.arange(4), np.arange(5, S)])
    coefs = rm.term_coefs(eps)
    out = torch.empty((me.shape[0], sentinel + 1), dtype=f64, device=device)
    out[:, sentinel] = NEG
    for n in range(1, 6):
        grids = np.meshgrid(*([np.arange(base)] * n), indexing="ij")
        frags = obs2int[np.stack([g.reshape(-1) for g in grids], -1)]
        fragx = np.concatenate([frags, np.full((len(frags), 1), 4)], 1)
        pat, ins, cls = rm.TERMS[n]
        z = fragx[:, np.where(pat < 0, n, pat)]  # [F, T, 3]
        midx = torch.as_tensor((z[..., 0] * S + z[..., 1]) * S + z[..., 2],
                               device=device)
        w = fragx[:, np.where(ins < 0, n, ins)]  # [F, T, 2]
        i0 = torch.as_tensor(w[..., 0], device=device)
        i1 = torch.as_tensor(w[..., 1], device=device)
        prob = torch.zeros((me.shape[0], len(frags)), dtype=f64, device=device)
        for t, c in enumerate(cls):
            prob += coefs[c] * qe[:, i0[:, t]] * qe[:, i1[:, t]] * me[:, midx[:, t]]
        out[:, offsets[n] : offsets[n] + len(frags)] = torch.log(prob)
    return out.to(dtype)


def specials(L: np.ndarray, multi_hits: bool, hmmer3_compat: bool) -> dict:
    """Length-dependent special transitions per read, float64 numpy."""
    L = np.asarray(L, np.float64)
    q = 0.5 if multi_hits else 0.0
    c = 2.0 + q / (1.0 - q)
    lp = np.log(L) - np.log(L + c)
    l1p = np.log(c) - np.log(L + c)
    loop = np.zeros_like(lp) if hmmer3_compat else lp
    full = lambda v: np.full_like(lp, v)  # noqa: E731
    return dict(
        NN=loop, CC=loop, JJ=loop, NB=l1p, CT=l1p, JB=l1p,
        EC=full(np.log(1.0 - q)), EJ=full(np.log(q) if multi_hits else NEG),
        RR=np.log(L) - np.log(L + 1.0),
    )


TRANS = ("entry", "mm_in", "im_in", "dm_in", "md_in", "dd_in", "mi", "ii")


@dataclass
class Profiles:
    """Profiles of one read class on the device, padded to K nodes."""

    fm: torch.Tensor  # [U, ntab, K] match fragment tables
    fi: torch.Tensor  # [U, ntab] insert
    fn: torch.Tensor  # [U, ntab] null (R, N, J, C)
    trans: dict  # name -> [U, K]; -inf past each core
    cdd: torch.Tensor  # [U, K] sum of dd_in over nodes 1..k
    valid: torch.Tensor  # [U, K] bool, inside the core
    models: list

    @classmethod
    def build(cls, models: list, codes: tuple, device, dtype):
        K = max(m.K for m in models)
        U = len(models)
        allm = tables(np.concatenate([m.match_codonp for m in models]),
                      np.concatenate([m.match_q for m in models]),
                      models[0].eps, codes, device, dtype)
        fm = torch.full((U, allm.shape[1], K), NEG, dtype=dtype, device=device)
        off = 0
        for u, m in enumerate(models):
            fm[u, :, : m.K] = allm[off : off + m.K].T
            off += m.K
        fi = tables(np.stack([m.insert_codonp for m in models]),
                    np.stack([m.insert_q for m in models]),
                    models[0].eps, codes, device, dtype)
        fn = tables(np.stack([m.null_codonp for m in models]),
                    np.stack([m.null_q for m in models]),
                    models[0].eps, codes, device, dtype)
        trans = {}
        for name in TRANS:
            a = np.full((U, K), NEG)
            for u, m in enumerate(models):
                a[u, : m.K] = getattr(m, name)
            trans[name] = torch.as_tensor(a, device=device).to(dtype)
        dd = np.zeros((U, K))
        for u, m in enumerate(models):
            dd[u, 1 : m.K] = m.dd_in[1:]
        cdd = torch.as_tensor(np.cumsum(dd, 1), device=device).to(dtype)
        valid = torch.arange(K, device=device)[None] < torch.as_tensor(
            [m.K for m in models], device=device)[:, None]
        return cls(fm, fi, fn, trans, cdd, valid, models)


def _shift(a):  # node k takes node k - 1's value; node 0 takes -inf
    return torch.cat([torch.full_like(a[..., :1], NEG), a[..., :-1]], -1)


def pairs(prof: Profiles, fidx: torch.Tensor, lens: np.ndarray, u: np.ndarray,
          r: np.ndarray, semiring: str = "max", multi_hits: bool = True,
          hmmer3_compat: bool = False, trace: bool = False):
    """Score pair n = (profile u[n], read r[n]): (alt [N], null [N])
    float64 numpy, and with ``trace`` (Viterbi only) each pair's best
    path as [(kind, node, length)], kind one of S N B M I D E J C T and
    node -1 for the specials.  ``fidx`` [R, Lp, 5] start-indexed fragment
    rows of the reads (model.fragment_starts), on the tables' device."""
    if trace and semiring != "max":
        raise ValueError("paths are traced under Viterbi only")
    dev, dtype = prof.fm.device, prof.fm.dtype
    join = torch.maximum if semiring == "max" else torch.logaddexp
    red = (lambda a, d: a.amax(d)) if semiring == "max" else torch.logsumexp
    cum = ((lambda a: torch.cummax(a, 1).values) if semiring == "max"
           else (lambda a: torch.logcumsumexp(a, 1)))
    u_t = torch.as_tensor(u, device=dev)
    r_t = torch.as_tensor(r, device=dev)
    N, K = len(u), prof.fm.shape[2]
    Lr = np.asarray(lens)[r]
    xt = {k: torch.as_tensor(v, device=dev).to(dtype)
          for k, v in specials(Lr, multi_hits, hmmer3_compat).items()}
    tr = {k: v[u_t] for k, v in prof.trans.items()}
    md_next = torch.cat([tr["md_in"][:, 1:], torch.full_like(tr["md_in"][:, :1], NEG)], 1)
    cdd = prof.cdd[u_t]
    cdd_next = torch.cat([cdd[:, 1:], cdd[:, -1:]], 1)
    valid = prof.valid[u_t]
    fmT = prof.fm
    sentinel = fmT.shape[1] - 1  # the -inf row of every table
    red0 = ((lambda a: a.amax(0)) if semiring == "max"
            else (lambda a: torch.logsumexp(a, 0)))
    neg5K = torch.full((5, N, K), NEG, dtype=dtype, device=dev)
    neg5 = torch.full((5, N), NEG, dtype=dtype, device=dev)
    # the last five positions' values, newest (i - 1) first; position 0
    # is S (0), B (NB) and the null model's start (0, no RR)
    HM, HI, HD = neg5K, neg5K, neg5K
    HN, HJ, HC, HE = neg5, neg5, neg5, neg5
    HS, HB, HR = neg5.clone(), neg5.clone(), neg5.clone()
    HS[0], HB[0], HR[0] = 0.0, xt["NB"], 0.0
    alt = torch.full((N,), NEG, dtype=dtype, device=dev)
    null = alt.clone()
    Lmax = int(Lr.max())
    Lt = torch.as_tensor(Lr, device=dev)
    ns = torch.arange(1, 6, device=dev)
    keep = {n: [] for n in ("M", "I", "dD", "E", "N", "J", "C", "B", "T")}

    def push(H, new):
        return torch.cat([new[None], H[:-1]])

    def best(c):  # reduce over candidates; their first best under trace
        if trace:
            return c.amax(0), torch.argmax(c, 0)
        return red0(c), None

    for i in range(1, Lmax + 1):
        pos = i - ns  # fragments of length n end at i, start at i - n
        f = fidx[r_t[None, :], pos.clamp(min=0)[:, None], (ns - 1)[:, None]]
        f = torch.where((pos >= 0)[:, None], f, sentinel)  # [5, N]
        emM = fmT[u_t[None, :], f]  # [5, N, K]
        emI = prof.fi[u_t[None, :], f]
        emN = prof.fn[u_t[None, :], f]
        cM = torch.stack([HB[..., None] + tr["entry"], _shift(HM) + tr["mm_in"],
                          _shift(HI) + tr["im_in"], _shift(HD) + tr["dm_in"]], 1)
        accM, argM = best((cM + emM[:, None]).reshape(20, N, K))
        cI = torch.stack([HM + tr["mi"], HI + tr["ii"]], 1) + emI[:, None, :, None]
        accI, argI = best(cI.reshape(10, N, K))
        cN = torch.stack([HS, HN], 1) + xt["NN"] + emN[:, None]
        cJ = torch.stack([HE + xt["EJ"] + xt["JJ"], HJ + xt["JJ"]], 1) + emN[:, None]
        cC = torch.stack([HE + xt["EC"] + xt["CC"], HC + xt["CC"]], 1) + emN[:, None]
        accN, argN = best(cN.reshape(10, N))
        accJ, argJ = best(cJ.reshape(10, N))
        accC, argC = best(cC.reshape(10, N))
        accR = red0(HR + emN)
        # the D chain at this position: D_k = join(M_{k-1} md, D_{k-1} dd),
        # as a prefix scan telescoped by the sum of dd
        Mflat = torch.where(valid, accM, NEG)
        b = cum(Mflat + md_next - cdd_next)
        VDn = torch.where(valid, cdd + _shift(b), NEG)
        VDn[:, 0] = NEG
        if trace:
            chain = _shift(VDn) + tr["dd_in"]
            direct = _shift(Mflat) + tr["md_in"]
            keep["dD"].append(chain > direct)
            flatE = torch.cat([Mflat, VDn], 1)
            VEn = flatE.amax(1)
            keep["E"].append(torch.argmax(flatE, 1))
        else:
            VEn = join(red(Mflat, 1), red(VDn, 1))
        candB = torch.stack([accN + xt["NB"], VEn + xt["EJ"] + xt["JB"],
                             accJ + xt["JB"]])
        candT = torch.stack([VEn + xt["EC"] + xt["CT"], accC + xt["CT"]])
        VBn, VT = red(candB, 0), red(candT, 0)
        if trace:
            keep["B"].append(torch.argmax(candB, 0) + 1)
            keep["T"].append(torch.argmax(candT, 0))
            for k, a in (("M", argM), ("I", argI), ("N", argN), ("J", argJ),
                         ("C", argC)):
                keep[k].append(a.to(torch.int16) if k in "MI" else a)
        hit = Lt == i
        alt = torch.where(hit, VT, alt)
        null = torch.where(hit, accR, null)
        HM, HI, HD = push(HM, Mflat), push(HI, torch.where(valid, accI, NEG)), push(HD, VDn)
        HN, HJ, HC, HE = push(HN, accN), push(HJ, accJ), push(HC, accC), push(HE, VEn)
        HS, HB, HR = push(HS, neg5[0]), push(HB, VBn), push(HR, accR + xt["RR"])
    alt = alt.double().cpu().numpy()
    null = null.double().cpu().numpy()
    if not trace:
        return alt, null
    ys = {k: torch.stack(v).cpu().numpy() for k, v in keep.items()}
    paths = [_walk(ys, n, int(Lr[n]), K) for n in range(N)]
    return alt, null, paths


def _walk(ys, n: int, L: int, K: int) -> list[tuple[str, int, int]]:
    """Pair n's best path from the kept origins (rows indexed i - 1)."""
    path = [("T", -1, 0)]
    i = L
    cur = ("E", -1) if ys["T"][i - 1, n] == 0 else ("C", -1)
    for _ in range(L * (K + 8) + 16):
        kind, k = cur
        if kind == "S":
            path.append(("S", -1, 0))
            path.reverse()
            return path
        if kind == "E":
            path.append(("E", -1, 0))
            e = int(ys["E"][i - 1, n])
            cur = ("M", e) if e < K else ("D", e - K)
        elif kind in "NJC":
            code = int(ys[kind][i - 1, n])
            ln, o = code // 2 + 1, code % 2
            path.append((kind, -1, ln))
            i -= ln
            cur = ({"N": "SN", "J": "EJ", "C": "EC"}[kind][o], -1)
        elif kind == "B":
            path.append(("B", -1, 0))
            cur = ("S", -1) if i == 0 else ("SNEJ"[int(ys["B"][i - 1, n])], -1)
        elif kind == "M":
            code = int(ys["M"][i - 1, n, k])
            ln, o = code // 4 + 1, code % 4
            path.append(("M", k, ln))
            i -= ln
            cur = ("BMID"[o], -1 if o == 0 else k - 1)
        elif kind == "I":
            code = int(ys["I"][i - 1, n, k])
            ln, o = code // 2 + 1, code % 2
            path.append(("I", k, ln))
            i -= ln
            cur = ("MI"[o], k)
        elif kind == "D":
            path.append(("D", k, 0))
            cur = ("D" if ys["dD"][i - 1, n, k] else "M", k - 1)
    raise RuntimeError("the reference's walk did not end")


EMITS = set("NJCMI")


def path_score(m: rm.Model, tabs: dict, fidx: np.ndarray, L: int, path,
               multi_hits: bool = True, hmmer3_compat: bool = False) -> float:
    """log-probability (float64) of ``path`` [(kind, node, length)] over a
    read of L symbols under model ``m``; -inf where the path is not one
    of the model's, or does not consume the read exactly.  ``tabs`` holds
    the float64 numpy fragment tables fm [K, ntab], fi, fn."""
    xt = {k: float(v[0]) for k, v in specials([L], multi_hits, hmmer3_compat).items()}
    if not path or path[0][0] != "S" or path[-1][0] != "T":
        return NEG
    total, pos = 0.0, 0
    prev = path[0]
    if prev[2] != 0:
        return NEG
    for cur in path[1:]:
        (pk, pn, _), (ck, cn, ln) = prev, cur
        t = _trans(m, xt, pk, pn, ck, cn)
        if t == NEG:
            return NEG
        total += t
        if ck in EMITS:
            if not 1 <= ln <= 5 or pos + ln > L:
                return NEG
            row = fidx[pos, ln - 1]
            total += (tabs["fm"][cn, row] if ck == "M"
                      else tabs["fi"][row] if ck == "I" else tabs["fn"][row])
            pos += ln
        elif ln != 0:
            return NEG
        prev = cur
    return total if pos == L else NEG


def _trans(m, xt, pk, pn, ck, cn) -> float:
    K = m.K
    core = {"M", "I", "D"}
    if ck in core and not 0 <= cn < K:
        return NEG
    if pk == "S":
        return {"N": xt["NN"], "B": xt["NB"]}.get(ck, NEG) if cn == -1 else NEG
    if pk == "N":
        return {"N": xt["NN"], "B": xt["NB"]}.get(ck, NEG)
    if pk == "B":
        return m.entry[cn] if ck == "M" else NEG
    if pk == "E":
        return {"C": xt["EC"] + xt["CC"], "T": xt["EC"] + xt["CT"],
                "J": xt["EJ"] + xt["JJ"], "B": xt["EJ"] + xt["JB"]}.get(ck, NEG)
    if pk == "C":
        return {"C": xt["CC"], "T": xt["CT"]}.get(ck, NEG)
    if pk == "J":
        return {"J": xt["JJ"], "B": xt["JB"]}.get(ck, NEG)
    if ck == "E":
        return 0.0 if pk == "M" or (pk == "D" and pn >= 1) else NEG
    nxt = cn == pn + 1
    if pk == "M":
        if ck == "M" and nxt:
            return m.mm_in[cn]
        if ck == "I" and cn == pn:
            return m.mi[cn]
        if ck == "D" and nxt:
            return m.md_in[cn]
    if pk == "I":
        if ck == "M" and nxt:
            return m.im_in[cn]
        if ck == "I" and cn == pn:
            return m.ii[cn]
    if pk == "D":
        if ck == "M" and nxt:
            return m.dm_in[cn]
        if ck == "D" and nxt:
            return m.dd_in[cn]
    return NEG
