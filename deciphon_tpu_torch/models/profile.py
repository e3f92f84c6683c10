"""Protein profile construction and its dense tensor form.

This is the tensor-native replacement for the reference's pointer-graph model
build (src/model/protein_model.c) + DP compilation (protein_profile_absorb,
src/model/protein_profile.c:218-257).  Instead of an imm_hmm compiled into a
sparse imm_dp, a profile compiles into dense per-node arrays that the scan
engines (ops/) consume directly:

  - per-node codon log-marginal tables  match_marg[K, 125]
  - per-node background nuclt log-probs match_q[K, 5] (index 4 = log 1)
  - shared insert/null (R,N,J,C) distribution tables
  - destination-indexed core transition vectors (mm_in, im_in, dm_in, md_in,
    dd_in) and source-indexed insert transitions (mi, ii)
  - the entry distribution entry[K] (B -> M_k; uniform or match-occupancy,
    protein_model.c:258-283 and :410-439)

Special-state transitions that depend on the target sequence length are
computed per scan by ``special_transitions`` (mirrors protein_profile_setup,
src/model/protein_profile.c:155-216).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from deciphon_tpu_torch.models import frame
from deciphon_tpu_torch.models.alphabet import AMINO, DNA, GeneticCode, STANDARD_CODE
from deciphon_tpu_torch.utils.rc import einval
from deciphon_tpu_torch.utils.xmath import log1mexp, logsumexp

LOG0 = -np.inf

# HMMER3 Swiss-Prot 50.8 background amino-acid frequencies, in AMINO
# ("ACDEFGHIKLMNPQRSTVWY") order (reference: src/model/protein_h3reader.c:79-103).
NULL_AMINO_FREQS = np.array(
    [
        0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
        0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
        0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
        0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
    ]
)
NULL_AMINO_LPROBS = np.log(NULL_AMINO_FREQS)

ENTRY_DIST_UNIFORM = "uniform"
ENTRY_DIST_OCCUPANCY = "occupancy"

# Core transition order within a trans row, matching the HMMER3 file order
# (reference: include/deciphon/model/protein_trans.h / hmr HMR_TRANS_*).
TRANS_MM, TRANS_MI, TRANS_MD, TRANS_IM, TRANS_II, TRANS_DM, TRANS_DD = range(7)


@dataclass(frozen=True)
class ProteinCfg:
    """Press-time model configuration (reference: protein_cfg.h:13-23)."""

    entry_dist: str = ENTRY_DIST_OCCUPANCY
    epsilon: float = 0.01


@dataclass
class SpecialTrans:
    """Length-dependent special-state transitions (log-probs).

    Mirrors protein_profile_setup (src/model/protein_profile.c:155-216).
    Field names follow the reference's xtrans: NN is the cost of each N
    emission step (also S->N), NB leaves the N loop, etc.
    """

    NN: float
    NB: float
    EC: float
    CC: float
    CT: float
    EJ: float
    JJ: float
    JB: float
    RR: float


def special_transitions(
    seq_size: int, multi_hits: bool = True, hmmer3_compat: bool = False
) -> SpecialTrans:
    if seq_size <= 0:
        raise einval("sequence cannot be empty")
    L = float(seq_size)
    if multi_hits:
        q = 0.5
        log_q = np.log(0.5)
    else:
        q = 0.0
        log_q = LOG0
    lp = np.log(L) - np.log(L + 2 + q / (1 - q))
    l1p = np.log(2 + q / (1 - q)) - np.log(L + 2 + q / (1 - q))
    lr = np.log(L) - np.log(L + 1)
    nn = cc = jj = lp
    if hmmer3_compat:
        nn = cc = jj = 0.0
    return SpecialTrans(
        NN=nn, NB=l1p, EC=np.log(1 - q), CC=cc, CT=l1p,
        EJ=log_q, JJ=jj, JB=l1p, RR=lr,
    )


@dataclass
class ProteinProfile:
    """Dense tensorized protein profile (one profile)."""

    accession: str
    core_size: int
    consensus: str
    cfg: ProteinCfg

    # emission tables (float64 host-side; engines cast as needed)
    match_marg: np.ndarray  # [K, 125]
    match_q: np.ndarray  # [K, 5]
    insert_marg: np.ndarray  # [125]
    insert_q: np.ndarray  # [5]
    null_marg: np.ndarray  # [125]  (R, N, J, C share the null dist,
    null_q: np.ndarray  # [5]       reference: protein_model.c:239-256)

    # codon log-probs for posterior decode (subset of marg with no ANYs)
    match_codonp: np.ndarray  # [K, 64]
    insert_codonp: np.ndarray  # [64]
    null_codonp: np.ndarray  # [64]

    # transitions, destination-indexed (index k = node k receiving)
    entry: np.ndarray  # [K]   B -> M_k
    mm_in: np.ndarray  # [K]   M_{k-1} -> M_k   (k=0 -> -inf)
    im_in: np.ndarray  # [K]   I_{k-1} -> M_k
    dm_in: np.ndarray  # [K]   D_{k-1} -> M_k
    md_in: np.ndarray  # [K]   M_{k-1} -> D_k
    dd_in: np.ndarray  # [K]   D_{k-1} -> D_k
    # source-indexed insert transitions (k = node k's insert)
    mi: np.ndarray  # [K]      M_k -> I_k      (k=K-1 -> -inf)
    ii: np.ndarray  # [K]      I_k -> I_k

    name: str = ""

    def fragment_tables(self, base: int = 4, codes: tuple | None = None):
        """(F_match [K,T], F_insert [T], F_null [T]) log scores, where
        T = 1365 (base 4) or 3906 (base 5, IUPAC N-extended).

        ``codes`` (a tuple of IUPAC ambiguity letters) switches to the
        exact-subset extended tables over base 4+len(codes): every
        degenerate observed symbol scores as the sum of the fragment
        probability over its nucleotide subset (frame.IUPAC_SUBSETS).
        ``codes=('N',)`` is numerically identical to ``base=5``.
        """
        eps = self.cfg.epsilon
        if codes is not None and tuple(codes) not in ((), ("N",)):
            codes = tuple(codes)
            fm = frame.fragment_table_codes(
                self.match_codonp, self.match_q, eps, codes
            )
            fi = frame.fragment_table_codes(
                self.insert_codonp, self.insert_q, eps, codes
            )
            fn = frame.fragment_table_codes(
                self.null_codonp, self.null_q, eps, codes
            )
            return fm, fi, fn
        if codes == ("N",):
            base = 5
        fm = frame.fragment_table(self.match_marg, self.match_q, eps, base)
        fi = frame.fragment_table(self.insert_marg, self.insert_q, eps, base)
        fn = frame.fragment_table(self.null_marg, self.null_q, eps, base)
        return fm, fi, fn


class ProteinModelBuilder:
    """Incremental profile builder fed by the HMMER3 reader.

    Usage mirrors the reference flow (protein_model_setup / add_node /
    add_trans, driven by protein_h3reader_next):

        b = ProteinModelBuilder(cfg)
        b.setup(core_size)
        b.add_trans(row0)           # BEGIN -> node 0 transitions
        for each node: b.add_node(match_lprobs, consensus_char)
                       b.add_trans(row)
        profile = b.finalize(accession)
    """

    def __init__(
        self,
        cfg: ProteinCfg = ProteinCfg(),
        null_lprobs: np.ndarray = NULL_AMINO_LPROBS,
        gc: GeneticCode = STANDARD_CODE,
    ):
        self.cfg = cfg
        self.gc = gc
        self.null_lprobs = np.asarray(null_lprobs, dtype=np.float64)
        self.core_size = 0
        self._match_lodds: list[np.ndarray] = []
        self._consensus: list[str] = []
        self._trans: list[np.ndarray] = []

    def setup(self, core_size: int) -> None:
        if core_size <= 0:
            raise einval("core_size cannot be zero")
        from deciphon_tpu_torch.utils.limits import CORE_SIZE_MAX

        if core_size > CORE_SIZE_MAX:
            raise einval(
                f"core_size {core_size} exceeds the maximum "
                f"{CORE_SIZE_MAX} (reference core/limits.h:11)"
            )
        self.core_size = core_size
        self._match_lodds = []
        self._consensus = []
        self._trans = []

    def add_node(self, amino_lprobs: np.ndarray, consensus: str = "-") -> None:
        if len(self._match_lodds) == self.core_size:
            raise einval("reached limit of nodes")
        lodds = np.asarray(amino_lprobs, dtype=np.float64) - self.null_lprobs
        self._match_lodds.append(lodds)
        self._consensus.append(consensus)

    def add_trans(self, trans_row: np.ndarray) -> None:
        if len(self._trans) == self.core_size + 1:
            raise einval("reached limit of transitions")
        self._trans.append(np.asarray(trans_row, dtype=np.float64))

    # -- entry distribution -------------------------------------------------

    def _occupancy(self, trans: np.ndarray) -> np.ndarray:
        """Match-occupancy entry distribution.

        Log-space prefix recurrence over B->...->M_k reachability
        (reference: calculate_occupancy, src/model/protein_model.c:258-283).
        """
        K = self.core_size
        locc = np.empty(K)
        locc[0] = np.logaddexp(trans[0, TRANS_MI], trans[0, TRANS_MM])
        for i in range(1, K):
            v0 = locc[i - 1] + np.logaddexp(
                trans[i, TRANS_MM], trans[i, TRANS_MI]
            )
            v1 = log1mexp(locc[i - 1]) + trans[i, TRANS_DM]
            locc[i] = np.logaddexp(v0, v1)
        logz = logsumexp(locc + np.log(K - np.arange(K)))
        return locc - logz

    def finalize(self, accession: str = "", name: str = "") -> ProteinProfile:
        K = self.core_size
        if len(self._match_lodds) != K or len(self._trans) != K + 1:
            raise einval("model is incomplete")
        trans = np.stack(self._trans)  # [K+1, 7]

        # emission distributions
        lodds = np.stack(self._match_lodds)  # [K, 20]
        match_codonp = frame.codon_lprob_from_amino(lodds, self.gc)
        match_q = frame.q5_pad(frame.nuclt_lprob_from_codon(match_codonp))
        match_marg = frame.codon_marg(match_codonp)

        insert_codonp = frame.codon_lprob_from_amino(np.zeros(20), self.gc)
        insert_q = frame.q5_pad(frame.nuclt_lprob_from_codon(insert_codonp))
        insert_marg = frame.codon_marg(insert_codonp)

        null_codonp = frame.codon_lprob_from_amino(self.null_lprobs, self.gc)
        null_q = frame.q5_pad(frame.nuclt_lprob_from_codon(null_codonp))
        null_marg = frame.codon_marg(null_codonp)

        # entry distribution (setup_entry_trans, protein_model.c:410-439)
        if self.cfg.entry_dist == ENTRY_DIST_UNIFORM:
            M = float(K)
            # NB: the reference multiplies the log by M
            # (protein_model.c:415); kept verbatim for parity.
            entry = np.full(K, np.log(2.0 / (M * (M + 1.0))) * M)
        else:
            entry = self._occupancy(trans)

        # destination-indexed core transitions.  trans[j] carries the
        # transitions from node j-1 to node j (trans[0] = BEGIN row, whose
        # MM/MD are superseded by the entry distribution; setup_transitions,
        # protein_model.c:460-500).
        mm_in = np.full(K, LOG0)
        im_in = np.full(K, LOG0)
        dm_in = np.full(K, LOG0)
        md_in = np.full(K, LOG0)
        dd_in = np.full(K, LOG0)
        if K > 1:
            mm_in[1:] = trans[1:K, TRANS_MM]
            im_in[1:] = trans[1:K, TRANS_IM]
            dm_in[1:] = trans[1:K, TRANS_DM]
            md_in[1:] = trans[1:K, TRANS_MD]
            dd_in[1:] = trans[1:K, TRANS_DD]
        mi = np.full(K, LOG0)
        ii = np.full(K, LOG0)
        if K > 1:
            mi[: K - 1] = trans[1:K, TRANS_MI]
            ii[: K - 1] = trans[1:K, TRANS_II]

        return ProteinProfile(
            accession=accession,
            name=name or accession,
            core_size=K,
            consensus="".join(self._consensus),
            cfg=self.cfg,
            match_marg=match_marg,
            match_q=match_q,
            insert_marg=insert_marg,
            insert_q=insert_q,
            null_marg=null_marg,
            null_q=null_q,
            match_codonp=match_codonp,
            insert_codonp=insert_codonp,
            null_codonp=null_codonp,
            entry=entry,
            mm_in=mm_in,
            im_in=im_in,
            dm_in=dm_in,
            md_in=md_in,
            dd_in=dd_in,
            mi=mi,
            ii=ii,
        )


def sample_profile(
    seed: int, core_size: int, cfg: ProteinCfg = ProteinCfg()
) -> ProteinProfile:
    """Random profile for tests.

    Mirrors protein_profile_sample's structure (seeded amino dists per node +
    normalized transition rows with the BEGIN/END rows' DD/MD zeroed,
    src/model/protein_profile.c:259-304) but uses numpy's PCG64 stream — the
    reference's imm_rnd stream is not reproducible without the imm sources,
    so golden values derived from it are re-pinned for this implementation.
    """
    assert core_size >= 2
    rng = np.random.default_rng(seed)

    def sample_lprobs(n):
        with np.errstate(divide="ignore"):
            lp = np.log(rng.random(n))
        return lp - logsumexp(lp)

    # the reference samples the model's null amino dist first, then the
    # per-node dists, then the transition rows — same order here.
    null_lprobs = sample_lprobs(20)
    b = ProteinModelBuilder(cfg, null_lprobs=null_lprobs)
    b.setup(core_size)
    node_lprobs = [sample_lprobs(20) for _ in range(core_size)]
    rows = []
    for i in range(core_size + 1):
        row = sample_lprobs(7)
        if i == 0:
            row[TRANS_DD] = LOG0
        if i == core_size:
            row[TRANS_MD] = LOG0
            row[TRANS_DD] = LOG0
        row = row - logsumexp(row)
        rows.append(row)
    b.add_trans(rows[0])
    for i in range(core_size):
        b.add_node(node_lprobs[i], "-")
        b.add_trans(rows[i + 1])
    return b.finalize(accession=f"sample-{seed}-{core_size}")
