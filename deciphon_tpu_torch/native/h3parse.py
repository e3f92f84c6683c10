"""Native-accelerated HMMER3 reading with pure-Python fallback.

Drop-in faster versions of models/h3reader.read_h3 / count_profiles: the
C++ tokenizer (native/h3parse.cpp) yields the same H3Profile stream,
including residue-order permutation into AMINO order.
"""

from __future__ import annotations

import ctypes
from typing import Iterator

import numpy as np

from deciphon_tpu_torch.models.alphabet import AMINO
from deciphon_tpu_torch.models.h3reader import H3Profile
from deciphon_tpu_torch.models.h3reader import count_profiles as _py_count
from deciphon_tpu_torch.models.h3reader import read_h3 as _py_read
from deciphon_tpu_torch.native import load
from deciphon_tpu_torch.utils.rc import eparse


def read_h3_native(path: str) -> Iterator[H3Profile]:
    lib = load()
    if lib is None:
        yield from _py_read(path)
        return
    h = lib.dcp_h3_open(path.encode())
    if not h:
        raise eparse(f"cannot open {path}")
    try:
        while True:
            k = lib.dcp_h3_next(h)
            if k == 0:
                return
            if k < 0:
                raise eparse(
                    f"{path}: {lib.dcp_h3_error(h).decode()}"
                )
            residues = lib.dcp_h3_residues(h).decode()
            perm = np.array([AMINO.index(r) for r in residues])
            inv = np.empty(20, dtype=np.int64)
            inv[perm] = np.arange(20)

            match = np.ctypeslib.as_array(
                lib.dcp_h3_match(h), shape=(k, 20)
            ).copy()[:, inv]
            insert = np.ctypeslib.as_array(
                lib.dcp_h3_insert(h), shape=(k, 20)
            ).copy()[:, inv]
            trans = np.ctypeslib.as_array(
                lib.dcp_h3_trans(h), shape=(k + 1, 7)
            ).copy()
            name = lib.dcp_h3_name(h).decode()
            acc = lib.dcp_h3_accession(h).decode()
            cons = lib.dcp_h3_consensus(h).decode()
            yield H3Profile(
                name=name,
                accession=acc or name,
                length=k,
                match_lprobs=match,
                insert_lprobs=insert,
                trans=trans,
                consensus=cons,
            )
    finally:
        lib.dcp_h3_close(h)


def count_profiles_native(path: str) -> int:
    lib = load()
    if lib is None:
        return _py_count(path)
    n = lib.dcp_h3_count(path.encode())
    if n < 0:
        raise eparse(f"cannot open {path}")
    return int(n)
