"""Profile-kind dispatch over database files.

The reference routes every db through a typeid read at open time
(src/db/reader.c:54-79 header check feeding the profile vtable,
src/db/profile_reader.c:95-98); this module is the tensor-era
counterpart: sniff a database header WITHOUT loading the payload and
hand back the right container — 'protein' (TensorDB, the production
.dtp) or 'standard' (generic dense-HMM profiles, typeid 1).
"""

from __future__ import annotations

from deciphon_tpu_torch.utils.rc import eparse

PROTEIN = "protein"
STANDARD = "standard"


def peek_header(path: str) -> dict:
    """Read just the root-map 'header' value from a msgpack db file
    (streaming — the multi-GB profile payload is never touched)."""
    import msgpack

    with open(path, "rb") as fp:
        u = msgpack.Unpacker(
            fp, raw=False, strict_map_key=False,
            max_bin_len=2**33, max_str_len=2**31,
            max_array_len=2**31, max_map_len=2**31,
        )
        try:
            n = u.read_map_header()
            for _ in range(n):
                key = u.unpack()
                if key == "header":
                    return u.unpack()
                u.skip()
        except Exception as exc:  # noqa: BLE001
            raise eparse(f"not a profile database: {exc}") from exc
    raise eparse("no header in database file")


def db_typeid(path: str) -> str:
    """'protein' | 'standard' from the header, mirroring the reference's
    profile_typeid enum (src/model/profile_typeid.h:4-9)."""
    hdr = peek_header(path)
    tid = hdr.get("profile_typeid")
    if tid in (PROTEIN, 2):
        return PROTEIN
    if tid in (STANDARD, 1):
        return STANDARD
    raise eparse(f"unsupported profile typeid: {tid!r}")


def open_db(path: str):
    """(typeid, container): ('protein', TensorDB) or
    ('standard', list[StandardProfile])."""
    tid = db_typeid(path)
    if tid == PROTEIN:
        from deciphon_tpu_torch.db.format import TensorDB

        return PROTEIN, TensorDB.load(path)
    from deciphon_tpu_torch.db.standard_db import load_standard_db

    return STANDARD, load_standard_db(path)
