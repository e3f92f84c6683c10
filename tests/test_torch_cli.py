"""The port's CLI vs the JAX package's, on the verify recipe's DB.

``python -m deciphon_tpu_torch.cli.main scan --device cpu`` must write the
product rows of ``deciphon_tpu.cli.main scan`` (CPU/XLA engine): equal
apart from the logliks, which agree within 1e-4.
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
    return tmp, dtp, fasta, p.accession


def _rows(path):
    return [line.split("\t") for line in path.read_text().splitlines()[1:]]


@pytest.mark.parametrize("flags", [[], ["--lrt-threshold=-1e9"],
                                   ["--no-multi-hits", "--hmmer3-compat",
                                    "--lrt-threshold=-1e9"]])
def test_scan_rows_match_jax_cli(recipe, flags, capsys):
    tmp, dtp, fasta, acc = recipe
    ref, got = tmp / "jax.tsv", tmp / "torch.tsv"
    assert jax_main(["scan", str(dtp), str(fasta), "-o", str(ref),
                     *flags]) == 0
    assert torch_main(["scan", str(dtp), str(fasta), "-o", str(got),
                       "--device", "cpu", "--batch-size", "1", *flags]) == 0
    capsys.readouterr()
    want, have = _rows(ref), _rows(got)
    assert have and len(have) == len(want)
    if not flags:
        assert [(r[1], r[2]) for r in have] == [("1", acc)]
    for g, w in zip(have, want):
        assert g[:4] + g[6:] == w[:4] + w[6:]  # all but the logliks
        for col in (4, 5):
            assert float(g[col]) == pytest.approx(float(w[col]), abs=1e-4)


def test_info_and_errors(recipe, capsys):
    tmp, dtp, fasta, _ = recipe
    assert torch_main(["info", str(dtp)]) == 0
    assert "profiles:   4" in capsys.readouterr().out
    # missing db -> EIO exit, IUPAC read -> EINVAL exit (not ported yet)
    assert torch_main(["scan", str(tmp / "nope.dtp"), str(fasta),
                       "--device", "cpu"]) != 0
    amb = tmp / "amb.fa"
    amb.write_text(">n\nACGTNACGT\n")
    assert torch_main(["scan", str(dtp), str(amb), "-o",
                       str(tmp / "x.tsv"), "--device", "cpu"]) != 0
    capsys.readouterr()
