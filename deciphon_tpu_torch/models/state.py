"""Protein-profile state-id scheme and naming.

Mirrors the reference's 16-bit encoding: top 2 bits = kind (MATCH, INSERT,
DELETE, EXT), low bits = node index or special-state ordinal
(reference: include/deciphon/model/protein_state.h:7-57,
src/model/protein_state.c:5-39).
"""

from __future__ import annotations

BITS = 16
MATCH = 0 << (BITS - 2)
INSERT = 1 << (BITS - 2)
DELETE = 2 << (BITS - 2)
EXT = 3 << (BITS - 2)

R = EXT | 0
S = EXT | 1
N = EXT | 2
B = EXT | 3
E = EXT | 4
J = EXT | 5
C = EXT | 6
T = EXT | 7

_EXT_NAMES = {R: "R", S: "S", N: "N", B: "B", E: "E", J: "J", C: "C", T: "T"}


def match_id(node_idx: int) -> int:
    return MATCH | (node_idx + 1)


def insert_id(node_idx: int) -> int:
    return INSERT | (node_idx + 1)


def delete_id(node_idx: int) -> int:
    return DELETE | (node_idx + 1)


def kind(state_id: int) -> int:
    return state_id & (3 << (BITS - 2))


def is_match(state_id: int) -> bool:
    return kind(state_id) == MATCH


def is_insert(state_id: int) -> bool:
    return kind(state_id) == INSERT


def is_delete(state_id: int) -> bool:
    return kind(state_id) == DELETE


def is_ext(state_id: int) -> bool:
    return kind(state_id) == EXT


def is_mute(state_id: int) -> bool:
    if is_ext(state_id):
        return state_id in (S, B, E, T)
    return is_delete(state_id)


def node_idx(state_id: int) -> int:
    """0-based core-node index of an M/I/D state."""
    return (state_id & (0xFFFF >> 2)) - 1


def name(state_id: int) -> str:
    """Render a state name: 'M1', 'I27', 'D3', 'R', 'S', ... ."""
    if is_ext(state_id):
        return _EXT_NAMES[state_id]
    prefix = {MATCH: "M", INSERT: "I", DELETE: "D"}[kind(state_id)]
    return f"{prefix}{node_idx(state_id) + 1}"


def standard_name(state_idx: int) -> str:
    """Name a generic (non-codon) profile state: 'S0', 'S1', ...

    The reference's standard/generic profile kind names states by bare
    index (src/model/standard_state.c:124-129).  Kept for the typeid-1
    profile family, which the reference defines but never instantiates
    from databases (src/db/profile_reader.c:95-98 only builds PROTEIN).
    """
    return f"S{state_idx}"
