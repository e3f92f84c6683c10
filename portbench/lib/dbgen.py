"""The profile database of a configuration: drawn, written, pressed, cached.

A configuration's DB keys (``DB_KEYS``) fix the draw: ``nprofiles`` core
sizes from a lognormal (median ``median``, sigma ``sigma``) clipped to
``clip``, plus the ``outliers``, and HMMER-shaped random profiles from
``db_seed`` (each match column puts ``peak`` of its mass on one amino
acid).  ``h3_params`` draws every profile at once; ``write_hmm`` writes
them as a HMMER3/f text file in bulk; ``pressed`` presses that file with
the program's own ``press`` command in a subprocess and keeps both files
under ``portbench/cache/``, keyed by the draw and by a hash of the
program's press sources, so only a checkout's first run presses.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / "portbench" / "cache"
AMINO = "ACDEFGHIKLMNPQRSTVWY"
# the program's files that decide what `press` writes
PRESS_SOURCES = ("deciphon_tpu_torch/models", "deciphon_tpu_torch/db/format.py",
                 "deciphon_tpu_torch/native", "deciphon_tpu_torch/cli/main.py")
# a configuration's keys that fix its DB (its scan flags do not)
DB_KEYS = ("nprofiles", "db_seed", "median", "sigma", "clip", "outliers", "peak",
           "epsilon", "entry_dist")


def db_of(config: dict) -> dict:
    return {k: config[k] for k in DB_KEYS}


def core_sizes(db: dict) -> np.ndarray:
    """The draw of bench.py:201-209: lognormal core sizes, clipped, then
    the outliers."""
    rng = np.random.default_rng(db["db_seed"])
    n = db["nprofiles"] - len(db["outliers"])
    sizes = np.exp(rng.normal(np.log(db["median"]), db["sigma"], n))
    sizes = np.clip(sizes, *db["clip"]).astype(np.int64)
    return np.concatenate([sizes, db["outliers"]]).astype(np.int64)


@dataclass
class H3Params:
    """Every profile's parameters, nodes stacked: profile i owns nodes
    off[i]:off[i+1] and transition rows off[i]+i : off[i+1]+i+1."""

    sizes: np.ndarray  # [P]
    off: np.ndarray  # [P + 1]
    match: np.ndarray  # [nodes, 20] ln p
    insert: np.ndarray  # [nodes, 20] ln p
    trans: np.ndarray  # [nodes + P, 7] ln p: MM MI MD IM II DM DD

    def profile(self, i: int):
        s, e = int(self.off[i]), int(self.off[i + 1])
        return self.match[s:e], self.insert[s:e], self.trans[s + i : e + i + 1]


def h3_params(db: dict) -> H3Params:
    """HMMER-shaped random profiles (as models/h3writer.random_h3 shapes
    them), drawn in bulk from the configuration's db_seed."""
    sizes = core_sizes(db)
    off = np.concatenate([[0], np.cumsum(sizes)])
    nodes, P = int(off[-1]), len(sizes)
    rng = np.random.default_rng([db["db_seed"], 1])

    def dists(n):
        a = rng.random((n, 20)) + 1e-3
        return a / a.sum(1, keepdims=True)

    match = dists(nodes) * (1.0 - db["peak"])
    match[np.arange(nodes), rng.integers(0, 20, nodes)] += db["peak"]
    match /= match.sum(1, keepdims=True)
    insert = dists(nodes)
    rows = nodes + P
    r = rng.random((rows, 5))
    mm = 0.9 + 0.08 * r[:, 0]
    mi = (1 - mm) * r[:, 1]
    im = 0.7 + 0.2 * r[:, 2]
    dm = 0.7 + 0.2 * r[:, 3]
    with np.errstate(divide="ignore"):
        trans = np.log(np.stack([mm, mi, 1 - mm - mi, im, 1 - im, dm, 1 - dm], 1))
    first = off[:-1] + np.arange(P)  # each profile's BEGIN row
    last = off[1:] + np.arange(P)  # each profile's last node's row
    trans[first, 6] = -np.inf  # no D0 -> D1
    trans[last, 2] = -np.inf  # no M -> D past the last node
    trans[last, 6] = -np.inf
    return H3Params(sizes, off, np.log(match), np.log(insert), trans)


def _fixed(lp: np.ndarray) -> np.ndarray:
    """[..., 8] bytes: '-ln p' right-aligned with five decimals, '*' for
    p = 0 (HMMER3's columns; values below 100)."""
    x = -lp
    inf = ~np.isfinite(x)
    v = np.rint(np.where(inf, 0.0, x) * 1e5).astype(np.int64)
    if (v >= 100 * 10**5).any() or (v < 0).any():
        raise ValueError("a -ln p column outside [0, 100)")
    out = np.full(x.shape + (8,), ord(" "), np.uint8)
    ip, fp = v // 10**5, v % 10**5
    out[..., 0] = np.where(ip >= 10, ord("0") + ip // 10, ord(" "))
    out[..., 1] = ord("0") + ip % 10
    out[..., 2] = ord(".")
    for d in range(5):
        out[..., 7 - d] = ord("0") + (fp // 10**d) % 10
    out[inf] = np.frombuffer(b"       *", np.uint8)
    return out


def _row(lp: np.ndarray) -> np.ndarray:
    """[n, 10 * c - 2] bytes: the columns joined by two spaces."""
    f = _fixed(lp)
    n, c = lp.shape
    out = np.full((n, c, 10), ord(" "), np.uint8)
    out[:, :, :8] = f
    return out.reshape(n, c * 10)[:, :-2]


def _int(v: np.ndarray, width: int) -> np.ndarray:
    out = np.full((len(v), width), ord(" "), np.uint8)
    for d in range(width):
        p = 10**d
        digit = ord("0") + (v // p) % 10
        out[:, width - 1 - d] = np.where((v >= p) | (d == 0), digit, ord(" "))
    return out


def _bytes(s: str, n: int) -> np.ndarray:
    return np.tile(np.frombuffer(s.encode(), np.uint8), (n, 1))


def write_hmm(path: Path, prm: H3Params) -> list[int]:
    """Write every profile as HMMER3/f text; returns the byte offset of
    each profile and the file's end."""
    sizes, off = prm.sizes, prm.off
    nodes = int(off[-1])
    k1 = np.concatenate([np.arange(1, s + 1) for s in sizes])
    body_rows = np.ones(len(prm.trans), bool)
    body_rows[off[:-1] + np.arange(len(sizes))] = False
    cons = np.frombuffer(AMINO.lower().encode(), np.uint8)[np.argmax(prm.match, 1)]
    node = np.concatenate([
        _int(k1, 7), _bytes("  ", nodes), _row(prm.match), _bytes("  ", nodes),
        _int(k1, 6), _bytes(" ", nodes), cons[:, None], _bytes(" - -\n", nodes),
        _bytes(" " * 9, nodes), _row(prm.insert), _bytes("\n", nodes),
        _bytes(" " * 9, nodes), _row(prm.trans[body_rows]), _bytes("\n", nodes),
    ], 1)
    begin_trans = _row(prm.trans[~body_rows])
    begin_ins = _row(prm.insert[off[:-1]])
    compo = _row(np.log(np.full((1, 20), 1 / 20)))[0].tobytes().decode()
    offsets = []
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as fp:
        for i, K in enumerate(sizes):
            offsets.append(fp.tell())
            acc = f"PB{i:05d}.{K}"
            fp.write((
                "HMMER3/f [3.3.2 | portbench]\n"
                f"NAME  pb{i:05d}\nACC   {acc}\nLENG  {K}\nALPH  amino\n"
                "RF    no\nMM    no\nCONS  yes\nCS    no\nMAP   yes\n"
                "HMM    " + "        ".join(AMINO) + "\n"
                "        m->m     m->i     m->d     i->m     i->i     d->m"
                "     d->d\n"
                f"  COMPO  {compo}\n"
                f"         {begin_ins[i].tobytes().decode()}\n"
                f"         {begin_trans[i].tobytes().decode()}\n"
            ).encode())
            fp.write(node[off[i] : off[i + 1]].tobytes())
            fp.write(b"//\n")
        offsets.append(fp.tell())
    os.replace(tmp, path)
    return offsets


def _press_hash(db: dict) -> str:
    h = hashlib.sha256(json.dumps(db, sort_keys=True).encode())
    h.update(Path(__file__).read_bytes())
    for rel in PRESS_SOURCES:
        p = ROOT / rel
        for f in sorted(p.rglob("*.py")) if p.is_dir() else [p]:
            h.update(str(f.relative_to(ROOT)).encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


@dataclass
class PressedDB:
    dtp: Path
    hmm: Path
    offsets: list[int]
    pressed_s: float  # seconds this run spent writing and pressing (0 if cached)

    def text(self, i: int) -> str:
        """Profile i's text, as the .hmm file holds it."""
        with open(self.hmm, "rb") as fp:
            fp.seek(self.offsets[i])
            return fp.read(self.offsets[i + 1] - self.offsets[i]).decode()


def pressed(db: dict, params: H3Params | None = None) -> PressedDB:
    """The configuration's DB as a pressed .dtp, pressed here on a miss."""
    where = CACHE / f"db_{_press_hash(db)}"
    where.mkdir(parents=True, exist_ok=True)
    dtp, hmm, index = where / "db.dtp", where / "db.hmm", where / "index.json"
    with open(where / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if dtp.exists() and index.exists():
            return PressedDB(dtp, hmm, json.loads(index.read_text()), 0.0)
        t0 = time.perf_counter()
        offsets = write_hmm(hmm, params or h3_params(db))
        tmp = where / "db.dtp.tmp"
        cmd = [sys.executable, "-m", "deciphon_tpu_torch.cli.main", "press",
               str(hmm), "-o", str(tmp), "--epsilon", str(db["epsilon"])]
        if db["entry_dist"] == "uniform":
            cmd.append("--uniform-entry")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"press failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, dtp)
        index.write_text(json.dumps(offsets))
        return PressedDB(dtp, hmm, offsets, time.perf_counter() - t0)
