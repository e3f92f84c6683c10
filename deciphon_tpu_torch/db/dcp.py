"""Structural reader for the reference's .dcp profile databases.

A host copy of deciphon_tpu/db/dcp.py (msgpack and the standard
library only).

The reference stores a pressed database as one MessagePack document
(reference: src/db/writer.c:95-117 assembles the root 2-key map; the
reference's file-format.md documents the layout):

    {"header": {magic_number (0xC6F0, types.h), profile_typeid,
                float_size, entry_dist, epsilon, abc (Bin, imm_abc),
                amino (Bin, imm_abc), profile_sizes (lite_pack 1darray u32)},
     "profiles": [ 16-key map per profile, src/model/protein_profile.c:38-117:
                accession, null (Bin, imm_dp), alt (Bin, imm_dp), core_size,
                consensus, R,S,N,B,E,J,C,T, null_ndist, alt_insert_ndist,
                alt_match_ndist ]}

The DP tensors inside the ``null``/``alt`` bins use imm's private packing
(the imm library is an external dependency of the reference, not part of
it), so this module reads everything *around* them: header configuration,
per-profile metadata, special-state indices, and byte extents — enough to
inventory a reference database, verify press parity (profile counts, core
sizes, accessions, epsilon/entry-dist config), and size partitions the way
profile_reader does (src/db/profile_reader.c:44-72 prefix sums over
profile_sizes).

lite_pack encodes 1darrays as a MessagePack ext whose type tags the element
kind; item bytes follow in file order.  Without lite_pack vendored we accept
both byte orders (validated against the element-count invariant) plus the
plain-array form, and unit tests pin all three.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import msgpack

from deciphon_tpu_torch.utils.rc import eparse

DCP_MAGIC = 0xC6F0  # reference src/db/types.h:11

PROFILE_TYPEIDS = {1: "standard", 2: "protein"}  # profile_typeid.h:4-9
ENTRY_DISTS = {1: "uniform", 2: "occupancy"}  # model/entry_dist.h


@dataclass
class DcpProfile:
    accession: str
    core_size: int
    consensus: str
    specials: dict[str, int]  # R,S,N,B,E,J,C,T state indices
    null_dp_nbytes: int
    alt_dp_nbytes: int
    # raw parsed msgpack values of the imm_dp objects, for the
    # invariant-driven decode attempt (db/dcp_dp.py)
    null_obj: object = None
    alt_obj: object = None

    def decode_dp(self):
        """Attempt the imm_dp tensor extraction on this profile's alt/null
        objects (db/dcp_dp.decode_imm_dp).  Returns (null, alt) ImmDp on
        success; raises DcpDpError carrying the structural analysis."""
        from deciphon_tpu_torch.db.dcp_dp import decode_imm_dp

        null = decode_imm_dp(self.null_obj, self.core_size, is_alt=False)
        alt = decode_imm_dp(self.alt_obj, self.core_size, is_alt=True)
        return null, alt


@dataclass
class DcpInfo:
    magic: int
    profile_typeid: int
    float_size: int
    entry_dist: int
    epsilon: float | None
    abc_nbytes: int
    amino_nbytes: int
    profile_sizes: list[int]
    profiles: list[DcpProfile] = field(default_factory=list)

    @property
    def nprofiles(self) -> int:
        return len(self.profile_sizes)

    @property
    def typeid_name(self) -> str:
        return PROFILE_TYPEIDS.get(self.profile_typeid, "?")

    @property
    def entry_dist_name(self) -> str:
        return ENTRY_DISTS.get(self.entry_dist, "?")


def _u32_list(payload: bytes, n_hint: int | None = None) -> list[int]:
    """Decode a packed u32 buffer, choosing the byte order that yields
    plausible (small, nonzero) profile sizes."""
    if len(payload) % 4:
        raise eparse("1darray payload not a whole number of u32s")
    n = len(payload) // 4
    be = list(struct.unpack(f">{n}I", payload))
    le = list(struct.unpack(f"<{n}I", payload))
    # profile byte sizes are modest (< 256 MiB each, limits.h envelope);
    # the wrong byte order turns them astronomically large
    big = 1 << 28
    be_ok = all(0 < v < big for v in be)
    le_ok = all(0 < v < big for v in le)
    if be_ok and not le_ok:
        return be
    if le_ok and not be_ok:
        return le
    return be  # ambiguous (tiny values): msgpack convention is big-endian


def _as_int_list(obj, what: str) -> list[int]:
    """Accept a 1darray in any encoding we may meet: a standard msgpack
    array of ints, or a lite_pack ext holding packed u32s."""
    if isinstance(obj, msgpack.ExtType):  # ExtType is itself a tuple
        return _u32_list(obj.data)
    if isinstance(obj, (list, tuple)):
        return [int(v) for v in obj]
    if isinstance(obj, (bytes, bytearray)):
        return _u32_list(bytes(obj))
    raise eparse(f"cannot decode {what}: unexpected type {type(obj).__name__}")


def _as_str(v, what: str) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).rstrip(b"\x00").decode("ascii", "replace")
    raise eparse(f"{what} is not a string")


def _bin_len(v) -> int:
    if isinstance(v, (bytes, bytearray)):
        return len(v)
    if isinstance(v, msgpack.ExtType):
        return len(v.data)
    # imm objects pack as Bins (file-format.md); nested plain objects
    # still count as present
    return 0


_SPECIALS = ("R", "S", "N", "B", "E", "J", "C", "T")


def parse_dcp(data: bytes) -> DcpInfo:
    """Parse a .dcp document from memory. See module docstring for scope."""
    unpacker = msgpack.Unpacker(
        None, raw=False, strict_map_key=False, max_buffer_size=0
    )
    unpacker.feed(data)
    try:
        root = unpacker.unpack()
    except Exception as e:  # noqa: BLE001 — uniform parse error
        raise eparse(f"not a MessagePack document: {e}") from None
    if not isinstance(root, dict):
        raise eparse("root is not a map")
    header = root.get("header")
    if not isinstance(header, dict):
        raise eparse("missing header map")

    magic = int(header.get("magic_number", -1))
    if magic != DCP_MAGIC:
        raise eparse(
            f"bad magic_number 0x{magic:X} (want 0x{DCP_MAGIC:X}): "
            "not a reference .dcp database"
        )
    info = DcpInfo(
        magic=magic,
        profile_typeid=int(header.get("profile_typeid", 0)),
        float_size=int(header.get("float_size", 0)),
        entry_dist=int(header.get("entry_dist", 0)),
        epsilon=(
            float(header["epsilon"]) if "epsilon" in header else None
        ),
        abc_nbytes=_bin_len(header.get("abc", b"")),
        amino_nbytes=_bin_len(header.get("amino", b"")),
        profile_sizes=_as_int_list(
            header.get("profile_sizes", []), "profile_sizes"
        ),
    )

    profiles = root.get("profiles", [])
    if not isinstance(profiles, (list, tuple)):
        raise eparse("profiles is not an array")
    for i, p in enumerate(profiles):
        if not isinstance(p, dict):
            raise eparse(f"profile {i} is not a map")
        info.profiles.append(
            DcpProfile(
                accession=_as_str(
                    p.get("accession", ""), f"profile {i} accession"
                ),
                core_size=int(p.get("core_size", 0)),
                consensus=_as_str(
                    p.get("consensus", ""), f"profile {i} consensus"
                ),
                specials={
                    k: int(p[k]) for k in _SPECIALS if k in p
                },
                null_dp_nbytes=_bin_len(p.get("null", b"")),
                alt_dp_nbytes=_bin_len(p.get("alt", b"")),
                null_obj=p.get("null"),
                alt_obj=p.get("alt"),
            )
        )
    if info.profiles and len(info.profiles) != info.nprofiles:
        raise eparse(
            f"profile count mismatch: {len(info.profiles)} profiles vs "
            f"{info.nprofiles} profile_sizes entries"
        )
    return info


def read_dcp(path: str) -> DcpInfo:
    with open(path, "rb") as fp:
        return parse_dcp(fp.read())
