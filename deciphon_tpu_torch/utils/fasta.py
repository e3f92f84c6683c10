"""Minimal FASTA reader/writer for local scan input (gzip-aware)."""

from __future__ import annotations

import gzip
from typing import Iterator


def _open_text(path: str):
    """Open possibly-gzipped text: sniff the 2-byte gzip magic rather
    than trusting the extension (read sets arrive named all sorts of
    ways)."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def read_fasta(path: str) -> Iterator[tuple[str, str]]:
    name = None
    chunks: list[str] = []
    with _open_text(path) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def write_fasta(path: str, records) -> None:
    with open(path, "w", encoding="utf-8") as fp:
        for name, seq in records:
            fp.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                fp.write(seq[i : i + 70] + "\n")
