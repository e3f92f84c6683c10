"""The port's own host modules vs the JAX package's originals, on the CPU.

deciphon_tpu_torch carries copies of the jax-free host modules of
deciphon_tpu (models, db, ops.emissions, ops.viterbi_ref, utils, native,
server.prod): the same inputs, made from a seed, must give EQUAL results
(tolerance 0: the code is the same, in f64 where it computes), each copy
built with the port's modules and each original with the JAX package's.
"""

import io

import numpy as np
import pytest

from deciphon_tpu.db import format as jformat
from deciphon_tpu.db import partition as jpartition
from deciphon_tpu.models import alphabet as jalphabet
from deciphon_tpu.models import codec as jcodec
from deciphon_tpu.models import h3reader as jh3reader
from deciphon_tpu.models import h3writer as jh3writer
from deciphon_tpu.models import profile as jprofile
from deciphon_tpu.ops import emissions as jemissions
from deciphon_tpu.ops import viterbi_ref as jvr
from deciphon_tpu.server import prod as jprod
from deciphon_tpu_torch.db import format as pformat
from deciphon_tpu_torch.db import partition as ppartition
from deciphon_tpu_torch.models import alphabet as palphabet
from deciphon_tpu_torch.models import codec as pcodec
from deciphon_tpu_torch.models import h3reader as ph3reader
from deciphon_tpu_torch.models import h3writer as ph3writer
from deciphon_tpu_torch.models import profile as pprofile
from deciphon_tpu_torch.ops import emissions as pemissions
from deciphon_tpu_torch.ops import scan_engine as pscan_engine
from deciphon_tpu_torch.ops import viterbi_ref as pvr
from deciphon_tpu_torch.server import prod as pprod


SPECS = [(1, 5), (2, 9), (3, 14)]  # (seed, core) of the sample profiles


def _reads(seed=0):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("ACGT"), int(n))) for n in (7, 19, 33)]
    reads.append("ACGNTRACGTYYACGN")
    return reads


def _dtp_bytes(tmp_path, h3writer, h3reader, fmt, name):
    hmm = tmp_path / f"{name}.hmm"
    with open(hmm, "w") as fp:
        h3writer.write_h3(fp, [h3writer.random_h3(s, k, peak=0.9)
                               for s, k in SPECS])
    dtp = tmp_path / f"{name}.dtp"
    fmt.write_db(str(dtp), h3reader.press_file(str(hmm)))
    return hmm.read_bytes(), dtp.read_bytes()


def case_press(tmp_path):
    return (_dtp_bytes(tmp_path, ph3writer, ph3reader, pformat, "port"),
            _dtp_bytes(tmp_path, jh3writer, jh3reader, jformat, "jax"))


def case_press_python_reader(tmp_path):
    """The pure-Python .hmm reader (the path when the native tokenizer
    is not built) presses the same profiles."""
    text = io.StringIO()
    ph3writer.write_h3(text, [ph3writer.random_h3(s, k) for s, k in SPECS])
    path = tmp_path / "py.hmm"
    path.write_text(text.getvalue())
    got = [p.match_marg for p in ph3reader.press_file(str(path),
                                                      use_native=False)]
    want = [p.match_marg for p in jh3reader.press_file(str(path),
                                                       use_native=False)]
    return got, want


def case_encode_extended(tmp_path):
    return ([palphabet.encode_extended(r) for r in _reads()],
            [jalphabet.encode_extended(r) for r in _reads()])


def case_fragment_indices(tmp_path):
    def run(mod, alph):
        out = []
        for r in _reads():
            enc, codes = alph.encode_extended(r)
            out.append(mod.fragment_indices(enc, pad_to=40,
                                            base=4 + len(codes)))
        return out

    return run(pemissions, palphabet), run(jemissions, jalphabet)


def case_fragment_tables(tmp_path):
    def run(mod):
        return [mod.sample_profile(s, k).fragment_tables(base=4 + len(c),
                                                         codes=c)
                for s, k in SPECS for c in ((), ("N",), ("N", "R"))]

    return run(pprofile), run(jprofile)


def case_profile_blocks(tmp_path):
    """The store's blocks against the JAX partitioner at the settings the
    port once called it with: one profile a row at the 32-lane width."""
    rng = np.random.default_rng(5)

    def cores(n):  # the benchmark's draw: median 150, sigma 0.8
        return np.clip(rng.lognormal(np.log(150), 0.8, n), 1,
                       4096).astype(np.int32)

    draws = [
        rng.integers(2, 900, 60), cores(4096), cores(19632),
        np.full(50, 77), np.array([31, 32, 33, 64, 65]), np.array([300]),
        np.zeros(0, np.int64),
    ]
    return ([pscan_engine.profile_blocks(sizes) for sizes in draws],
            [[(k, i) for k, _, _, i in jpartition.pack_profile_rows(
                sizes, lane=32, group=1, small_group_kpad=1 << 30,
                seg=False)] for sizes in draws])


def case_balanced_partitions(tmp_path):
    w = np.random.default_rng(6).integers(4, 400, 50)
    return ([list(ppartition.balanced_partitions(w, n)) for n in (1, 3, 7)],
            [list(jpartition.balanced_partitions(w, n)) for n in (1, 3, 7)])


def case_codec_render_match(tmp_path):
    def run(prof_mod, vr, codec, alph):
        out = []
        for (s, k), read in zip(SPECS, _reads(1)):
            prof = prof_mod.sample_profile(s, k)
            res = vr.viterbi_alt(prof, alph.DNA.encode(read))
            out.append(codec.render_match(
                codec.match_steps(prof, read, res.path)))
        return out

    return (run(pprofile, pvr, pcodec, palphabet),
            run(jprofile, jvr, jcodec, jalphabet))


def case_prod_writer_render(tmp_path):
    def run(prod):
        w = prod.ProdWriter(scan_id=3)
        w.add(1, "PF00001.1", -12.25, -30.5, "CG,M1,CGA,K")
        w.add(2, "PF00002.3", -1.0 / 3.0, -2.0 / 7.0, "")
        return w.render()

    return run(pprod), run(jprod)


def case_viterbi_ref(tmp_path):
    def run(prof_mod, vr, alph):
        out = []
        for (s, k), read in zip(SPECS, _reads(2)):
            prof = prof_mod.sample_profile(s, k)
            enc, codes = alph.encode_extended(read)
            for mh, h3 in ((True, False), (False, True)):
                a = vr.viterbi_alt(prof, enc, mh, h3, codes=codes)
                n = vr.viterbi_null(prof, enc, mh, h3, codes=codes)
                out.append((a.loglik, a.path, n.loglik))
        return out

    return run(pprofile, pvr, palphabet), run(jprofile, jvr, jalphabet)


CASES = [
    case_press, case_press_python_reader, case_encode_extended,
    case_fragment_indices, case_fragment_tables, case_profile_blocks,
    case_balanced_partitions, case_codec_render_match,
    case_prod_writer_render, case_viterbi_ref,
]


def _assert_equal(got, want):
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_copy_matches_original(case, tmp_path):
    got, want = case(tmp_path)
    _assert_equal(got, want)
