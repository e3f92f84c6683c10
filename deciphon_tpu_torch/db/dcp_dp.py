"""Best-effort decoder for imm_dp objects inside reference ``.dcp`` files.

A host copy of deciphon_tpu/db/dcp_dp.py (msgpack and numpy only).

The reference packs each profile's two DP matrices with ``imm_dp_pack``
(reference src/model/protein_profile.c:50-53), a function of the external
imm library (EBI-Metagenomics/imm 2.0.3, declared CMakeLists.txt:14) whose
sources are NOT part of the reference tree.  imm packs through the same
lite_pack stream as the surrounding document, so the "bins" are really
nested MessagePack values (maps / arrays / lite_pack 1darray exts) — they
parse structurally; what is undocumented is the SCHEMA: which keys/arrays
hold the state table, emission scores, and transitions.

This module therefore decodes by INVARIANT, not by schema:

  1. ``walk`` flattens any parsed msgpack value into typed leaf arrays,
     decoding lite_pack 1darray exts under every plausible element type.
  2. ``find_state_table`` searches the leaves for an integer array that is
     a permutation-free match for the protein state-id signature
     (reference include/deciphon/model/protein_state.h:7-21): an alt DP
     of core size K must contain exactly the 3K+7 ids
     {MATCH|k, INSERT|k, DELETE|k : k=1..K} + {S,N,B,E,J,C,T}, under the
     2-bit-kind << 14 encoding; a null DP is the single R id.  This
     signature cannot occur by accident in emission/transition payloads.
  3. With the state order fixed by that array, emission and transition
     arrays are identified by extent arithmetic: frame states emit
     length-1..5 nucleotide fragments, so an emission score pool must
     partition into per-state runs of Σ_l 4^l = 1364 (emitting) or 1
     (mute) entries, with an offsets array of length nstates+1 describing
     the partition.

``decode_imm_dp`` returns the extracted tensors when every invariant
checks out, and raises ``DcpDpError`` carrying a structural inventory of
the object (key paths, leaf extents, candidate interpretations) when it
does not: a failure analysis generated from the actual bytes instead of
written by hand.

No pressed reference asset ships with the repository and the imm sources
are not part of it, so the schema-dependent half of this decoder is
validated only by its invariants; the walker and the signature search
are unit-tested (tests/test_dcp_dp.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import msgpack
import numpy as np

# fragment-code pool sizes: Σ_l<=n 4^l
_CODES_PER_LEN = [4**l for l in range(1, 6)]
EMIT_POOL = sum(_CODES_PER_LEN)  # 1364 codes for a 1..5-span frame state

# protein_state.h:7-21 id scheme (BITS_PER_PROFILE_TYPEID = 16)
_KIND_SHIFT = 14
MATCH, INSERT, DELETE, EXT = (k << _KIND_SHIFT for k in range(4))
R_ID, S_ID, N_ID, B_ID, E_ID, J_ID, C_ID, T_ID = (EXT | i for i in range(8))
_SPECIAL_ALT = (S_ID, N_ID, B_ID, E_ID, J_ID, C_ID, T_ID)


class DcpDpError(ValueError):
    """imm_dp decode failure; ``str(err)`` carries the structural report."""


@dataclass
class Leaf:
    path: str
    raw: bytes | None  # ext/bin payload (None for plain arrays)
    ints: dict[str, np.ndarray] = field(default_factory=dict)
    floats: dict[str, np.ndarray] = field(default_factory=dict)

    def extents(self) -> str:
        kinds = {**self.ints, **self.floats}
        sizes = sorted({v.size for v in kinds.values()})
        return f"{self.path}: {sorted(kinds)} x {sizes}"


def _classify(path: str, payload: bytes) -> Leaf:
    """Decode a byte payload under every element type it divides into."""
    leaf = Leaf(path, payload)
    n = len(payload)
    for dt, name in (
        ("u1", "u8"), ("<u2", "u16le"), (">u2", "u16be"),
        ("<u4", "u32le"), (">u4", "u32be"), ("<u8", "u64le"),
        (">u8", "u64be"),
    ):
        width = np.dtype(dt).itemsize
        if n and n % width == 0:
            leaf.ints[name] = np.frombuffer(payload, dt).astype(np.int64)
    for dt, name in (
        ("<f4", "f32le"), (">f4", "f32be"),
        ("<f8", "f64le"), (">f8", "f64be"),
    ):
        width = np.dtype(dt).itemsize
        if n and n % width == 0:
            arr = np.frombuffer(payload, dt)
            # log-probabilities: finite-or-(-inf), magnitudes < 1e9
            fin = arr[np.isfinite(arr)]
            if fin.size == 0 or np.abs(fin).max() < 1e9:
                leaf.floats[name] = arr.astype(np.float64)
    return leaf


def walk(obj, path: str = "$") -> list[Leaf]:
    """Flatten any parsed msgpack value into classified leaves."""
    out: list[Leaf] = []
    if isinstance(obj, msgpack.ExtType):
        out.append(_classify(f"{path}#ext{obj.code}", obj.data))
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_classify(f"{path}#bin", bytes(obj)))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.extend(walk(v, f"{path}.{k}"))
    elif isinstance(obj, (list, tuple)):
        if obj and all(isinstance(v, (int, float)) for v in obj):
            leaf = Leaf(f"{path}[]", None)
            a = np.asarray(obj)
            if np.issubdtype(a.dtype, np.integer):
                leaf.ints["plain"] = a.astype(np.int64)
            else:
                leaf.floats["plain"] = a.astype(np.float64)
            out.append(leaf)
        else:
            for i, v in enumerate(obj):
                out.extend(walk(v, f"{path}[{i}]"))
    elif isinstance(obj, (int, float)):
        leaf = Leaf(path, None)
        if isinstance(obj, int):
            leaf.ints["scalar"] = np.asarray([obj])
        else:
            leaf.floats["scalar"] = np.asarray([float(obj)])
        out.append(leaf)
    return out


def expected_state_ids(core_size: int) -> set[int]:
    """The alt-DP id set for a core-``core_size`` protein profile."""
    ids = set(_SPECIAL_ALT)
    for k in range(1, core_size + 1):
        ids |= {MATCH | k, INSERT | k, DELETE | k}
    return ids


def find_state_table(
    leaves: list[Leaf], core_size: int, is_alt: bool
) -> tuple[np.ndarray, str] | None:
    """Search the leaves for the protein state-id signature; returns the
    id array IN FILE ORDER (fixing the DP's state indexing) + its path."""
    want = (
        expected_state_ids(core_size) if is_alt else {R_ID}
    )
    n = len(want)
    for leaf in leaves:
        for name, arr in leaf.ints.items():
            if arr.size == n and set(arr.tolist()) == want:
                return arr, f"{leaf.path}:{name}"
    return None


@dataclass
class ImmDp:
    """Extracted imm_dp content, in file state order."""

    state_ids: np.ndarray  # [nstates] protein state ids
    emis_offset: np.ndarray  # [nstates+1] into the emission pool
    emis_score: np.ndarray  # [pool] fragment-code log-probs
    trans_arrays: dict[str, np.ndarray]  # candidate transition payloads
    report: str


def _expected_pool(state_ids: np.ndarray) -> int:
    mute = {S_ID, B_ID, E_ID, T_ID} | {
        int(i) for i in state_ids if (i >> _KIND_SHIFT) == 2  # DELETE
    }
    pool = 0
    for sid in state_ids.tolist():
        pool += 1 if sid in mute else EMIT_POOL
    return pool


def decode_imm_dp(obj, core_size: int, is_alt: bool = True) -> ImmDp:
    """Decode one imm_dp msgpack value; raises DcpDpError with the
    structural inventory when any invariant fails."""
    leaves = walk(obj)
    inventory = "\n".join(f"  {leaf.extents()}" for leaf in leaves)
    hit = find_state_table(leaves, core_size, is_alt)
    if hit is None:
        raise DcpDpError(
            "no state-id array matching the protein_state.h signature "
            f"(need the {3 * core_size + 7 if is_alt else 1} ids of a "
            f"core-{core_size} {'alt' if is_alt else 'null'} DP).  "
            f"Structural inventory of the object:\n{inventory}"
        )
    state_ids, where = hit
    nstates = state_ids.size
    pool = _expected_pool(state_ids)

    # emission offsets: a nondecreasing int array of nstates+1 entries
    # ending at the pool size; emission scores: a float array of exactly
    # pool entries
    offs = None
    for leaf in leaves:
        for name, arr in leaf.ints.items():
            if (
                arr.size == nstates + 1
                and arr[0] == 0
                and np.all(np.diff(arr) >= 0)
                and arr[-1] == pool
            ):
                offs = (arr, f"{leaf.path}:{name}")
    score = None
    for leaf in leaves:
        for name, arr in leaf.floats.items():
            if arr.size == pool:
                score = (arr, f"{leaf.path}:{name}")
    if offs is None or score is None:
        raise DcpDpError(
            f"state table found at {where} ({nstates} states) but the "
            f"emission invariants failed: need offsets[{nstates + 1}] "
            f"ending at pool={pool} "
            f"({'found ' + offs[1] if offs else 'none found'}) and a "
            f"score array of {pool} floats "
            f"({'found ' + score[1] if score else 'none found'}).  "
            f"Structural inventory:\n{inventory}"
        )

    trans = {
        f"{leaf.path}:{name}": arr
        for leaf in leaves
        for name, arr in {**leaf.ints, **leaf.floats}.items()
    }
    return ImmDp(
        state_ids=state_ids,
        emis_offset=offs[0],
        emis_score=score[0],
        trans_arrays=trans,
        report=(
            f"state table: {where}; emission offsets: {offs[1]}; "
            f"emission scores: {score[1]} ({pool} entries)"
        ),
    )
