"""The port's CLI vs the JAX package's, on the verify recipe's DB.

``python -m deciphon_tpu_torch.cli.main scan --device cpu`` must write the
product rows of ``deciphon_tpu.cli.main scan`` (CPU/XLA engine): equal
apart from the logliks, which agree within 1e-4 (Viterbi) or 2e-3
(``--forward``), for ACGT reads and reads holding IUPAC codes.
"""

import numpy as np
import pytest

from deciphon_tpu.cli.main import main as jax_main
from deciphon_tpu.db.format import TensorDB
from deciphon_tpu.models.alphabet import STANDARD_CODE
from deciphon_tpu.models.h3writer import random_h3, write_h3
from deciphon_tpu_torch.cli.main import main as torch_main


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """.claude/skills/verify recipe: 4 profiles, a planted consensus read
    of profile 2 and a random read."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    hmm = tmp / "synth.hmm"
    with open(hmm, "w") as fp:
        write_h3(fp, [random_h3(s, k, peak=0.9)
                      for s, k in [(1, 6), (2, 11), (3, 17), (4, 8)]])
    dtp = tmp / "synth.dtp"
    assert torch_main(["press", str(hmm), "-o", str(dtp)]) == 0
    p = TensorDB.load(str(dtp)).profile(2)
    read = "".join(STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
                   for b in map(int, np.argmax(p.match_codonp, 1)))
    fasta = tmp / "reads.fa"
    fasta.write_text(
        f">planted\n{read}\n>random\nACGTACGTACGTACGTACGTACGTACGTACG\n"
    )
    # the recipe's consensus read with an N planted inside
    amb = tmp / "amb.fa"
    amb.write_text(f">planted_n\n{read[:5]}N{read[6:]}\n"
                   ">random_nr\nACGTNACGTACGRACGTACGTACGTACG\n")
    return tmp, dtp, fasta, p.accession


def _rows(path):
    return [line.split("\t") for line in path.read_text().splitlines()[1:]]


def _compare_with_jax(recipe, fasta, flags, tol):
    tmp, dtp, _, _ = recipe
    ref, got = tmp / "jax.tsv", tmp / "torch.tsv"
    assert jax_main(["scan", str(dtp), str(fasta), "-o", str(ref),
                     *flags]) == 0
    assert torch_main(["scan", str(dtp), str(fasta), "-o", str(got),
                       "--device", "cpu", "--batch-size", "1", *flags]) == 0
    want, have = _rows(ref), _rows(got)
    assert have and len(have) == len(want)
    for g, w in zip(have, want):
        assert g[:4] + g[6:] == w[:4] + w[6:]  # all but the logliks
        for col in (4, 5):
            assert float(g[col]) == pytest.approx(float(w[col]), abs=tol)
    return have


@pytest.mark.parametrize("flags", [[], ["--lrt-threshold=-1e9"],
                                   ["--no-multi-hits", "--hmmer3-compat",
                                    "--lrt-threshold=-1e9"]])
def test_scan_rows_match_jax_cli(recipe, flags, capsys):
    _, _, fasta, acc = recipe
    have = _compare_with_jax(recipe, fasta, flags, 1e-4)
    capsys.readouterr()
    if not flags:
        assert [(r[1], r[2]) for r in have] == [("1", acc)]


@pytest.mark.parametrize("flags", [[], ["--lrt-threshold=-1e9"]])
def test_cli_forward_flag(recipe, flags, capsys):
    """scan --forward writes forward logliks (the f64 forward oracle's,
    within 2e-3) with the Viterbi-path match strings of the JAX CLI."""
    from deciphon_tpu.models.alphabet import DNA
    from deciphon_tpu.ops import viterbi_ref as vr

    tmp, dtp, fasta, acc = recipe
    have = _compare_with_jax(recipe, fasta, ["--forward", *flags], 2e-3)
    capsys.readouterr()
    planted = [r for r in have if (r[1], r[2]) == ("1", acc)]
    assert planted
    read = fasta.read_text().splitlines()[1]
    prof = TensorDB.load(str(dtp)).profile(2)
    assert float(planted[0][4]) == pytest.approx(
        vr.forward_alt(prof, DNA.encode(read)), abs=2e-3
    )


@pytest.mark.parametrize("flags", [[], ["--forward"]])
def test_cli_iupac_rows_match_jax_cli(recipe, flags, capsys):
    """Reads with N (planted in the consensus read) and with N and R
    scan, and write the JAX CLI's rows; the planted read still hits."""
    _, _, _, acc = recipe
    tmp = recipe[0]
    have = _compare_with_jax(recipe, tmp / "amb.fa", flags,
                             2e-3 if flags else 1e-4)
    capsys.readouterr()
    assert ("1", acc) in [(r[1], r[2]) for r in have]


def test_info_and_errors(recipe, capsys):
    tmp, dtp, fasta, _ = recipe
    assert torch_main(["info", str(dtp)]) == 0
    assert "profiles:   4" in capsys.readouterr().out
    # missing db -> EIO exit; an IUPAC read scans (exit 0); a letter
    # that is no IUPAC code -> EINVAL exit
    from deciphon_tpu.utils.rc import RC

    assert torch_main(["scan", str(tmp / "nope.dtp"), str(fasta),
                       "--device", "cpu"]) == int(RC.EIO)
    amb = tmp / "n.fa"
    amb.write_text(">n\nACGTNACGT\n")
    assert torch_main(["scan", str(dtp), str(amb), "-o",
                       str(tmp / "x.tsv"), "--device", "cpu"]) == 0
    bad = tmp / "z.fa"
    bad.write_text(">z\nACGTZACGT\n")
    assert torch_main(["scan", str(dtp), str(bad), "-o",
                       str(tmp / "y.tsv"), "--device", "cpu"]) == int(
        RC.EINVAL)
    capsys.readouterr()
