"""Product (hit) TSV writer.

Byte-compatible with the reference's products file (src/server/prod.c:13-53,
:106-145): a header line then one row per hit —
scan_id, seq_id, profile_name, abc_name, alt_loglik, null_loglik,
profile_typeid, version, match — floats printed %.17g, match cells
';'-separated 'frag,state,codon,amino'.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field

from deciphon_tpu_torch import __version__


def default_version() -> str:
    """Version string stamped into the TSV 'version' column.

    Defaults to this package's version; set DCP_PROD_VERSION to stamp a
    different string (e.g. the reference's version, for byte-level diffs
    of product files against reference output)."""
    return os.environ.get("DCP_PROD_VERSION", __version__)

HEADER = (
    "scan_id\tseq_id\tprofile_name\tabc_name\talt_loglik\t"
    "null_loglik\tprofile_typeid\tversion\tmatch\n"
)


def _g17(x: float) -> str:
    """C "%.17g" formatting (shortest-of-17-significant-digits float)."""
    return f"{float(x):.17g}"


@dataclass
class ProdRow:
    scan_id: int
    seq_id: int
    profile_name: str
    abc_name: str
    alt_loglik: float
    null_loglik: float
    profile_typeid: str
    version: str
    match: str

    def render(self) -> str:
        return (
            f"{self.scan_id}\t{self.seq_id}\t{self.profile_name}\t"
            f"{self.abc_name}\t{_g17(self.alt_loglik)}\t"
            f"{_g17(self.null_loglik)}\t{self.profile_typeid}\t"
            f"{self.version}\t{self.match}\n"
        )


class ProdWriter:
    """Accumulates product rows, merges on close (the reference merges
    per-thread tempfiles, prod.c:106-145; workers here hand rows back to
    one writer)."""

    def __init__(
        self,
        scan_id: int = 0,
        abc_name: str = "dna",
        profile_typeid: str = "protein",
        version: str | None = None,
    ):
        if version is None:
            version = default_version()
        self.scan_id = scan_id
        self.abc_name = abc_name
        self.profile_typeid = profile_typeid
        self.version = version
        self.rows: list[ProdRow] = []

    def add(
        self,
        seq_id: int,
        profile_name: str,
        alt_loglik: float,
        null_loglik: float,
        match: str,
    ) -> ProdRow:
        row = ProdRow(
            self.scan_id, seq_id, profile_name, self.abc_name,
            alt_loglik, null_loglik, self.profile_typeid, self.version,
            match,
        )
        self.rows.append(row)
        return row

    def render(self) -> str:
        buf = io.StringIO()
        buf.write(HEADER)
        for row in self.rows:
            buf.write(row.render())
        return buf.getvalue()

    def write(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as fp:
            fp.write(self.render())
        return path
