"""The plain reference against the port's own plain code on a tiny DB.

Both read the same .hmm text (the port's reader and press; the
reference's parser and model); scores are held against the port's
float64 oracle (ops/viterbi_ref.py), paths by their score, match
strings letter for letter."""

import io

import numpy as np
import pytest
import torch

from portbench.reference import codec, dp, model as rm


@pytest.fixture(scope="module")
def tiny():
    from deciphon_tpu_torch.models.h3reader import build_profile, read_h3
    from deciphon_tpu_torch.models.h3writer import random_h3, write_h3

    texts = []
    for s, k in [(1, 6), (2, 11), (3, 17)]:
        buf = io.StringIO()
        write_h3(buf, random_h3(s, k, peak=0.8))
        texts.append(buf.getvalue())
    ports = [build_profile(next(read_h3(io.StringIO(t)))) for t in texts]
    models = [rm.build(rm.parse_h3(t)) for t in texts]
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACGT"), n)) for n in (7, 12, 20)]
    seqs.append(seqs[2][:9] + "N" + seqs[2][10:])
    return ports, models, seqs


def _class(models, seqs, idx, codes):
    enc = [rm.encode(seqs[i])[0] for i in idx]
    Lp = max(len(e) for e in enc)
    fidx = torch.as_tensor(np.stack([rm.fragment_starts(e, 4 + len(codes), Lp)
                                     for e in enc]))
    prof = dp.Profiles.build(models, codes, "cpu", torch.float64)
    u = np.repeat(np.arange(len(models)), len(idx))
    r = np.tile(np.arange(len(idx)), len(models))
    return prof, fidx, np.array([len(e) for e in enc]), u, r


@pytest.mark.parametrize("semiring", ["max", "lse"])
@pytest.mark.parametrize("codes,idx", [((), [0, 1, 2]), (("N",), [3])])
def test_scores_equal_the_port_oracle(tiny, semiring, codes, idx):
    from deciphon_tpu_torch.models.alphabet import encode_extended
    from deciphon_tpu_torch.ops import viterbi_ref as vr

    ports, models, seqs = tiny
    prof, fidx, lens, u, r = _class(models, seqs, idx, codes)
    alt, null = dp.pairs(prof, fidx, lens, u, r, semiring)
    for n in range(len(u)):
        enc, pc = encode_extended(seqs[idx[r[n]]])
        kw = dict(codes=pc or None)
        if semiring == "max":
            a = vr.viterbi_alt(ports[u[n]], enc, **kw).loglik
            b = vr.viterbi_null(ports[u[n]], enc, **kw).loglik
        else:
            a = vr.forward_alt(ports[u[n]], enc, **kw)
            b = vr.forward_null(ports[u[n]], enc, **kw)
        assert alt[n] == pytest.approx(a, abs=1e-9)
        assert null[n] == pytest.approx(b, abs=1e-9)


@pytest.mark.parametrize("codes,idx", [((), [0, 1, 2]), (("N",), [3])])
def test_paths_and_match_strings(tiny, codes, idx):
    from deciphon_tpu_torch.models import codec as pcodec
    from deciphon_tpu_torch.models.alphabet import encode_extended
    from deciphon_tpu_torch.ops import viterbi_ref as vr

    from portbench.lib.check import path_of

    ports, models, seqs = tiny
    prof, fidx, lens, u, r = _class(models, seqs, idx, codes)
    alt, _, paths = dp.pairs(prof, fidx, lens, u, r, "max", trace=True)
    for n in range(len(u)):
        m, seq = models[u[n]], seqs[idx[r[n]]]
        tabs = {"fm": prof.fm[u[n]].T.numpy(), "fi": prof.fi[u[n]].numpy(),
                "fn": prof.fn[u[n]].numpy()}
        f = fidx[r[n]].numpy()
        assert dp.path_score(m, tabs, f, lens[r[n]], paths[n]) == pytest.approx(alt[n])
        enc, pc = encode_extended(seq)
        res = vr.viterbi_alt(ports[u[n]], enc, codes=pc or None)
        theirs = path_of(res.path)
        assert dp.path_score(m, tabs, f, lens[r[n]], theirs) == pytest.approx(alt[n])
        want = pcodec.render_match(pcodec.match_steps(ports[u[n]], seq, res.path))
        assert ";".join(codec.cells(m, seq, theirs)) == want
        # without its first match step, the path is no path of the model
        i = next(j for j, s in enumerate(theirs) if s[0] == "M")
        bad = theirs[:i] + theirs[i + 1:]
        assert dp.path_score(m, tabs, f, lens[r[n]], bad) == float("-inf")


def test_bulk_writer_reads_back_in_both_readers(tmp_path):
    from deciphon_tpu_torch.models.h3reader import read_h3

    from portbench.lib import dbgen

    db = dict(nprofiles=5, db_seed=3, median=20, sigma=0.8, clip=[8, 40],
              outliers=[48], peak=0.8, epsilon=0.01, entry_dist="occupancy")
    prm = dbgen.h3_params(db)
    offs = dbgen.write_hmm(tmp_path / "x.hmm", prm)
    text = (tmp_path / "x.hmm").read_text()
    theirs = list(read_h3(io.StringIO(text)))
    assert len(theirs) == 5
    for i, t in enumerate(theirs):
        mine = rm.parse_h3(text[offs[i] : offs[i + 1]])
        match, _, trans = prm.profile(i)
        assert np.array_equal(t.match_lprobs, mine.match)
        assert np.array_equal(t.trans, mine.trans)
        assert np.allclose(mine.match, match, atol=6e-6)
        fin = np.isfinite(trans)
        assert np.array_equal(np.isfinite(mine.trans), fin)
        assert np.allclose(mine.trans[fin], trans[fin], atol=6e-6)
