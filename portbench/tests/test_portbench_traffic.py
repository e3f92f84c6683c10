"""Traffic comes from the seed alone, with the same make-up on every seed."""

import numpy as np
import pytest

from conftest import tiny_cell


def _make(cell, seed):
    from portbench.lib import dbgen

    prm = dbgen.h3_params(dbgen.db_of(cell.config))
    return cell.driver.generate(cell.mix, prm, seed)


@pytest.mark.parametrize("workload", ["pfam4k_vit.reads150_mix",
                                      "pfam4k_vit.genes_query"])
def test_same_seed_same_traffic(workload):
    cell = tiny_cell(workload)
    a, b, c = (_make(cell, s) for s in (2**31 + 5, 2**31 + 5, 7))
    assert [u.reads for u in a[0]] == [u.reads for u in b[0]]
    assert [u.reads for u in a[1]] == [u.reads for u in b[1]]
    assert [u.reads for u in a[0]] != [u.reads for u in c[0]]


def test_every_batch_has_the_mix_make_up():
    cell = tiny_cell("pfam4k_vit.reads150_mix")
    mix = cell.mix
    for seed in (1, 2):
        for u in _make(cell, seed)[0]:
            assert len(u.reads) == mix["batch"]
            assert {len(r) for r in u.reads} == {mix["read_nt"]}
            assert (u.source >= 0).sum() == mix["homologous"]
            withn = [i for i, r in enumerate(u.reads) if "N" in r]
            assert len(withn) == mix["with_n"]
            assert sum(u.source[i] >= 0 for i in withn) == mix["homologous_with_n"]


def test_homologs_come_from_the_whole_db_one_a_stratum():
    cell = tiny_cell("pfam4k_vit.reads150_mix")
    from portbench.lib import dbgen

    prm = dbgen.h3_params(dbgen.db_of(cell.config))
    n = cell.mix["homologous"]
    strata = np.array_split(np.argsort(prm.sizes, kind="stable"), n)
    seen = set()
    for seed in range(1, 9):
        for u in cell.driver.generate(cell.mix, prm, seed)[0]:
            src = u.source[u.source >= 0]
            # one profile from each stratum of core size in every batch
            assert sorted(int(np.flatnonzero([p in s for s in strata])[0]) for p in src) \
                == list(range(n))
            seen |= set(src.tolist())
    # seeds draw other profiles: every profile of the tiny DB comes up
    assert seen == set(range(len(prm.sizes)))


def test_requests_share_sizes_across_seeds():
    cell = tiny_cell("pfam4k_vit.genes_query")
    lens = []
    for seed in (1, 2):
        pool = _make(cell, seed)[0]
        r = cell.mix["round"]
        for i in range(0, len(pool), r):
            assert sum(u.source[0] >= 0 for u in pool[i : i + r]) == cell.mix["with_domain"]
        lens.append(np.array([len(u.reads[0]) for u in pool]))
        assert lens[-1].min() >= cell.mix["clip"][0] and lens[-1].max() <= cell.mix["clip"][1]
    # stratified: the two seeds' lengths differ by less than a stratum
    assert abs(np.median(lens[0]) - np.median(lens[1])) < 0.25 * np.median(lens[0])


def test_a_homolog_carries_its_profile():
    from portbench.lib import dbgen, traffic as tr

    cell = tiny_cell()
    prm = dbgen.h3_params(dbgen.db_of(cell.config))
    rng = np.random.default_rng(0)
    aa = tr.domain(rng, prm, 0, 30)
    match = prm.profile(0)[0]
    # peaked columns: most residues are their column's peak
    assert 0 < len(aa) <= 30
    dna = tr.back_translate(rng, aa)
    assert len(dna) == 3 * len(aa) and set(dna.tobytes().decode()) <= set("ACGT")
    assert match.shape[1] == 20
