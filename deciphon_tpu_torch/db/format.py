"""Tensorized profile database format (.dtp).

The TPU-native replacement for the reference's .dcp MessagePack database
(src/db/writer.c:95-117, and the reference's file-format.md).  Same
container technology (one MessagePack map), but the payload is the dense
tensor form the scan engines consume directly — per-node codon log-marginal
tables and transition vectors — instead of packed imm_dp objects, so a scan
loads straight into device memory with zero per-profile deserialization
(the reference re-reads and unpacks every profile from disk per sequence,
scan_thread.c:96-99; here the DB lives in HBM across the whole scan).

Layout: {header, metadata, arrays} with profiles stacked along a ragged
node axis (node_offset[i] slices profile i's nodes).
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Iterable, Iterator

import msgpack
import numpy as np

from deciphon_tpu_torch.models.profile import ProteinCfg, ProteinProfile
from deciphon_tpu_torch.utils.rc import RC, DcpError, eio, eparse

MAGIC = 0xD7B0
VERSION = 1

_NODE_ARRAYS = (
    "match_marg", "match_q", "entry", "mm_in", "im_in", "dm_in", "md_in",
    "dd_in", "mi", "ii",
)
_PROFILE_ARRAYS = ("null_marg", "null_q", "insert_marg", "insert_q")


def _pack_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"dtype": a.dtype.str, "shape": list(a.shape), "data": a.tobytes()}


def _unpack_array(d: dict) -> np.ndarray:
    a = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"])


def write_db(
    path: str,
    profiles: Iterable[ProteinProfile],
    cfg: ProteinCfg | None = None,
) -> int:
    """Write profiles to a .dtp file; returns the number written."""
    from deciphon_tpu_torch.utils.limits import MAX_NPROFILES
    from deciphon_tpu_torch.utils.rc import einval

    metadata = []
    per_node: dict[str, list] = {k: [] for k in _NODE_ARRAYS}
    per_prof: dict[str, list] = {k: [] for k in _PROFILE_ARRAYS}
    core_sizes = []
    for p in profiles:
        if len(metadata) >= MAX_NPROFILES:
            raise einval(
                f"database exceeds MAX_NPROFILES = {MAX_NPROFILES} "
                "(reference core/limits.h:7)"
            )
        if cfg is None:
            cfg = p.cfg
        metadata.append(
            {
                "accession": p.accession,
                "name": p.name,
                "core_size": p.core_size,
                "consensus": p.consensus,
            }
        )
        core_sizes.append(p.core_size)
        per_node["match_marg"].append(np.asarray(p.match_marg, np.float32))
        per_node["match_q"].append(np.asarray(p.match_q, np.float32))
        for k in _NODE_ARRAYS[2:]:
            per_node[k].append(np.asarray(getattr(p, k), np.float32))
        for k in _PROFILE_ARRAYS:
            per_prof[k].append(np.asarray(getattr(p, k), np.float32))
    if not metadata:
        raise DcpError(RC.EINVAL, "no profiles to write")
    cfg = cfg or ProteinCfg()

    core = np.asarray(core_sizes, np.int32)
    node_offset = np.zeros(len(core) + 1, np.int64)
    np.cumsum(core, out=node_offset[1:])

    arrays = {
        "core_size": _pack_array(core),
        "node_offset": _pack_array(node_offset),
    }
    for k, chunks in per_node.items():
        arrays[k] = _pack_array(np.concatenate(chunks, axis=0))
    for k, chunks in per_prof.items():
        arrays[k] = _pack_array(np.stack(chunks, axis=0))

    doc = {
        "header": {
            "magic": MAGIC,
            "version": VERSION,
            "profile_typeid": "protein",
            "float_bytes": 4,
            "entry_dist": cfg.entry_dist,
            "epsilon": float(cfg.epsilon),
            "abc": "dna",
            "amino": "ACDEFGHIKLMNPQRSTVWY",
            "nprofiles": len(metadata),
        },
        "metadata": metadata,
        "arrays": arrays,
    }
    with open(path, "wb") as fp:
        fp.write(msgpack.packb(doc, use_bin_type=True))
    return len(metadata)


@dataclass
class TensorDB:
    """Loaded tensorized profile database."""

    header: dict
    metadata: list[dict]
    arrays: dict[str, np.ndarray]
    path: str = ""

    @classmethod
    def load(cls, path: str) -> "TensorDB":
        with open(path, "rb") as fp:
            try:
                doc = msgpack.unpackb(
                    fp.read(), raw=False, strict_map_key=False,
                    max_bin_len=2**33, max_str_len=2**31,
                    max_array_len=2**31, max_map_len=2**31,
                )
            except Exception as exc:  # noqa: BLE001
                raise eparse(f"not a .dtp database: {exc}") from exc
        header = doc.get("header", {})
        if header.get("magic") != MAGIC:
            raise eparse("bad magic number (not a .dtp database)")
        if header.get("float_bytes") != 4:
            raise eparse("unsupported float width")
        arrays = {k: _unpack_array(v) for k, v in doc["arrays"].items()}
        return cls(header, doc["metadata"], arrays, path)

    @property
    def nprofiles(self) -> int:
        return int(self.header["nprofiles"])

    @property
    def cfg(self) -> ProteinCfg:
        return ProteinCfg(
            entry_dist=self.header["entry_dist"],
            epsilon=float(self.header["epsilon"]),
        )

    @property
    def core_sizes(self) -> np.ndarray:
        return self.arrays["core_size"]

    def profile_weights(self) -> np.ndarray:
        """Per-profile cost weights for partitioning — the tensor analogue
        of the reference's byte-size prefix sums (profile_reader.c:44-72)."""
        return self.core_sizes.astype(np.int64) + 2

    def profile(self, i: int) -> ProteinProfile:
        """Materialize profile i (views into the stacked arrays)."""
        if not 0 <= i < self.nprofiles:
            raise eio(f"profile index {i} out of range")
        off = self.arrays["node_offset"]
        s, e = int(off[i]), int(off[i + 1])
        meta = self.metadata[i]

        def node(k):
            return self.arrays[k][s:e].astype(np.float64)

        return ProteinProfile(
            accession=meta["accession"],
            name=meta.get("name", meta["accession"]),
            core_size=int(self.core_sizes[i]),
            consensus=meta.get("consensus", ""),
            cfg=self.cfg,
            match_marg=node("match_marg"),
            match_q=node("match_q"),
            insert_marg=self.arrays["insert_marg"][i].astype(np.float64),
            insert_q=self.arrays["insert_q"][i].astype(np.float64),
            null_marg=self.arrays["null_marg"][i].astype(np.float64),
            null_q=self.arrays["null_q"][i].astype(np.float64),
            match_codonp=_codonp_from_marg(
                self.arrays["match_marg"][s:e].astype(np.float64)
            ),
            insert_codonp=_codonp_from_marg(
                self.arrays["insert_marg"][i].astype(np.float64)
            ),
            null_codonp=_codonp_from_marg(
                self.arrays["null_marg"][i].astype(np.float64)
            ),
            entry=node("entry"),
            mm_in=node("mm_in"),
            im_in=node("im_in"),
            dm_in=node("dm_in"),
            md_in=node("md_in"),
            dd_in=node("dd_in"),
            mi=node("mi"),
            ii=node("ii"),
        )

    def profiles(self, indices=None) -> Iterator[ProteinProfile]:
        for i in indices if indices is not None else range(self.nprofiles):
            yield self.profile(int(i))


def _codonp_from_marg(marg125_log: np.ndarray) -> np.ndarray:
    """Exact codon log-probs are the no-ANY entries of the marginal table."""
    a, b, c = np.meshgrid(*([np.arange(4)] * 3), indexing="ij")
    idx = (a * 25 + b * 5 + c).reshape(-1)
    return marg125_log[..., idx]
