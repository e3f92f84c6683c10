"""The port's reference .dcp reader, imm_dp decoder, ``info`` on a .dcp
and ``parity`` vs the JAX package's, on the CPU.

The documents are the synthetic ones of tests/test_dcp.py and
tests/test_dcp_dp.py (no pressed reference asset ships with the repo);
the parity run uses a random_h3 .hmm, so its PF02545 golden checks stay
skipped in both packages, as tests/test_frame_degeneracy.py skips them.
"""

import dataclasses
import struct

import msgpack
import numpy as np
import pytest

from deciphon_tpu.db import dcp as jdcp
from deciphon_tpu.db import dcp_dp as jdp
from deciphon_tpu.utils.rc import DcpError as JDcpError
from deciphon_tpu_torch.db import dcp as pdcp
from deciphon_tpu_torch.db import dcp_dp as pdp
from deciphon_tpu_torch.utils.rc import DcpError as PDcpError
from tests.test_dcp import PROFILES, SIZES, doc_bytes, profile_map
from tests.test_dcp_dp import synth_dp


def info_fields(info) -> dict:
    """A parsed DcpInfo as plain values (its profiles as dicts)."""
    return dataclasses.asdict(info)


DOCS = {
    "plain sizes": lambda: doc_bytes(SIZES, PROFILES),
    "ext sizes, big endian": lambda: doc_bytes(
        msgpack.ExtType(3, struct.pack(">2I", *SIZES)), PROFILES),
    "ext sizes, little endian": lambda: doc_bytes(
        msgpack.ExtType(3, struct.pack("<2I", *SIZES)), PROFILES),
}
BAD_DOCS = {
    "bad magic": (lambda: doc_bytes(SIZES, PROFILES, magic=0xD7B0), "magic"),
    "not msgpack": (lambda: b"\xc1 not msgpack", "MessagePack"),
    "count mismatch": (lambda: doc_bytes([1, 2, 3], PROFILES), "mismatch"),
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_parse_dcp_equals_jax(name):
    data = DOCS[name]()
    got, want = pdcp.parse_dcp(data), jdcp.parse_dcp(data)
    assert info_fields(got) == info_fields(want)
    assert [p.core_size for p in got.profiles] == [3, 5]
    assert got.entry_dist_name == want.entry_dist_name == "occupancy"


@pytest.mark.parametrize("name", sorted(BAD_DOCS))
def test_bad_dcp_rejected_as_jax(name):
    make, match = BAD_DOCS[name]
    with pytest.raises(JDcpError, match=match) as want:
        jdcp.parse_dcp(make())
    with pytest.raises(PDcpError, match=match) as got:
        pdcp.parse_dcp(make())
    assert str(got.value) == str(want.value)


def test_walk_and_state_signature_equal_jax():
    obj = {
        "a": [1, 2, 3],
        "b": {"c": msgpack.ExtType(3, struct.pack("<4I", 1, 2, 3, 4))},
        "d": b"\x00" * 8,
        "e": 2.5,
    }
    got, want = pdp.walk(obj), jdp.walk(obj)
    assert [l.path for l in got] == [l.path for l in want]
    for g, w in zip(got, want):
        assert sorted(g.ints) == sorted(w.ints)
        for k in g.ints:
            np.testing.assert_array_equal(g.ints[k], w.ints[k])
    leaves = pdp.walk(synth_dp(5))
    ids, where = pdp.find_state_table(leaves, 5, is_alt=True)
    jids, jwhere = jdp.find_state_table(jdp.walk(synth_dp(5)), 5, True)
    np.testing.assert_array_equal(ids, jids)
    assert where == jwhere and ids[0] == pdp.S_ID
    assert pdp.expected_state_ids(5) == jdp.expected_state_ids(5)


@pytest.mark.parametrize("is_alt", [True, False])
def test_decode_imm_dp_equals_jax(is_alt):
    got = pdp.decode_imm_dp(synth_dp(4, is_alt), core_size=4, is_alt=is_alt)
    want = jdp.decode_imm_dp(synth_dp(4, is_alt), core_size=4,
                             is_alt=is_alt)
    for name in ("state_ids", "emis_offset", "emis_score"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert sorted(got.trans_arrays) == sorted(want.trans_arrays)
    for k, v in want.trans_arrays.items():
        np.testing.assert_array_equal(got.trans_arrays[k], v)
    assert got.report == want.report


@pytest.mark.parametrize("case", ["no signature", "wrong emission pool"])
def test_decode_failures_equal_jax(case):
    def make():
        if case == "no signature":
            return {"x": msgpack.ExtType(10, b"\x01\x02\x03\x04" * 7)}
        dp = synth_dp(3)
        dp["emis"]["score"] = msgpack.ExtType(10, b"\x00" * 16)
        return dp

    with pytest.raises(jdp.DcpDpError) as want:
        jdp.decode_imm_dp(make(), core_size=3)
    with pytest.raises(pdp.DcpDpError) as got:
        pdp.decode_imm_dp(make(), core_size=3)
    assert str(got.value) == str(want.value)


def cli_out(main, argv, capsys) -> tuple[int, str]:
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("decodable", [False, True])
def test_cli_info_on_dcp_prints_what_jax_prints(tmp_path, capsys,
                                                decodable):
    from deciphon_tpu.cli.main import main as jmain
    from deciphon_tpu_torch.cli.main import main as pmain

    p = profile_map("PF00001.1", 3)
    if decodable:
        p["null"], p["alt"] = synth_dp(3, False), synth_dp(3, True)
    path = tmp_path / "ref.dcp"
    path.write_bytes(doc_bytes([100], [p]))
    jrc, jout = cli_out(jmain, ["info", str(path)], capsys)
    prc, pout = cli_out(pmain, ["info", str(path)], capsys)
    assert prc == jrc == 0
    assert pout == jout
    assert "reference .dcp" in pout and "dp decode:" in pout
    assert ("dp decode:  ok" in pout) == decodable


def test_cli_parity_prints_and_writes_what_jax_does(tmp_path, capsys):
    from deciphon_tpu.cli.main import main as jmain
    from deciphon_tpu.models.h3reader import press_file
    from deciphon_tpu.models.h3writer import random_h3, write_h3
    from deciphon_tpu_torch.cli.main import main as pmain

    hmm = str(tmp_path / "synth.hmm")
    with open(hmm, "w") as fp:
        write_h3(fp, [random_h3(s, k, peak=0.9)
                      for s, k in ((1, 9), (2, 6))])
    # a .dcp whose metadata matches the press, and one that does not
    good, bad = tmp_path / "good.dcp", tmp_path / "bad.dcp"
    pressed = list(press_file(hmm))
    good.write_bytes(doc_bytes(
        [1, 1], [profile_map(q.accession, q.core_size) for q in pressed]))
    bad.write_bytes(doc_bytes([1], [profile_map("PF00001.1", 3)]))
    for extra in ([], [str(good)], [str(bad)], ["--strict"]):
        jtsv, ptsv = str(tmp_path / "j.tsv"), str(tmp_path / "p.tsv")
        jrc, jout = cli_out(jmain, ["parity", hmm, *extra, "-o", jtsv],
                            capsys)
        prc, pout = cli_out(pmain, ["parity", hmm, *extra, "-o", ptsv],
                            capsys)
        assert prc == jrc, extra
        assert pout.replace(ptsv, jtsv) == jout, extra
        assert open(ptsv).read() == open(jtsv).read()
        ok = "PARITY OK" in pout
        assert ok == (extra in ([], [str(good)])), pout
