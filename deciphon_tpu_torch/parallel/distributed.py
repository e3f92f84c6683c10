"""Multi-process scan over torch.distributed.

The counterpart of deciphon_tpu/parallel/distributed.py.  Every process
calls ``initialize()``; the mesh spans every process's device, in rank
order (``global_scan_mesh``); each process builds the tiles of its own
mesh slot (``make_global_block``) and scores them
(``global_viterbi_scores``): on the card with the Viterbi kernel
(csrc/viterbi.cu through ``viterbi_cuda.scores``), on the CPU with its
plain version.  The JAX package runs its XLA engine in this step
(pallas_scan._xla_sharded); the port runs the kernel, as
``ScanEngine(mesh=)`` does.

The process group's backend is gloo.  The JAX step has no collective:
``_xla_sharded`` is a shard_map with sharded out_specs and no psum, and
each process keeps its addressable shards.  So scores never travel
between processes here either, and the group carries only the
rendezvous and a barrier.  NCCL would add nothing, and it refuses two
ranks on one card, which is how a one-card machine runs two processes.

Start one process per DCP_PROC_ID, each with DCP_COORDINATOR=host:port
and DCP_NUM_PROCS; tests/test_torch_distributed.py runs two on the CPU,
chip_smoke.py two on the card.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops.scan_engine import resolve_device
from deciphon_tpu_torch.parallel.mesh import ScanMesh, make_scan_mesh
from deciphon_tpu_torch.parallel.sharded_scan import (
    Tile,
    seq_shards,
    shard_tiles,
)


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """torch.distributed.init_process_group (gloo, see the module
    docstring) at tcp://<coordinator>, with the JAX version's DCP_*
    environment fallbacks: DCP_COORDINATOR (host:port), DCP_NUM_PROCS,
    DCP_PROC_ID.  All three are required: nothing on a GPU machine tells
    a process of its cluster."""
    coordinator = coordinator or os.environ.get("DCP_COORDINATOR")
    if num_processes is None and os.environ.get("DCP_NUM_PROCS"):
        num_processes = int(os.environ["DCP_NUM_PROCS"])
    if process_id is None and os.environ.get("DCP_PROC_ID"):
        process_id = int(os.environ["DCP_PROC_ID"])
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            "need the coordinator (host:port), the number of processes and "
            "this process's id (DCP_COORDINATOR, DCP_NUM_PROCS, DCP_PROC_ID)"
        )
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
    )


def global_scan_mesh(profile_axis: int | None = None,
                     device: str = "cuda") -> ScanMesh:
    """('seqs' x 'profiles') mesh over every process's device, in rank
    order.  Rank r's device is cuda:{r % device_count} (so two ranks on
    one card share cuda:0) or, with ``device="cpu"``, the CPU; CUDA
    without a GPU raises."""
    kind = resolve_device(device).type
    world = dist.get_world_size()
    if kind == "cuda":
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", r % n) for r in range(world)]
    else:
        devices = [torch.device("cpu")] * world
    return make_scan_mesh(profile_axis=profile_axis, devices=devices)


def _local_slots(mesh: ScanMesh) -> set[int]:
    """This process's slots of ``mesh.devices``: one device per rank."""
    if len(mesh.devices) != dist.get_world_size():
        raise ValueError(f"mesh of {len(mesh.devices)} devices over "
                         f"{dist.get_world_size()} processes")
    return {dist.get_rank()}


def make_global_block(mesh: ScanMesh, block, kpad: int | None = None
                      ) -> list[Tile]:
    """This process's tiles of the profiles ``block`` (every process
    passes the same list), with their tables on its device.  The profile
    axis splits into the shards of pallas_scan._pad_axis0's padded axis,
    without its NEG rows (sharded_scan.profile_shards); ``kpad`` is the
    padded width (default: the widest core, LANE-rounded)."""
    if kpad is None:
        kpad = vc.pad_width(max(p.core_size for p in block))
    return shard_tiles(block, kpad, mesh, local=_local_slots(mesh))


def global_viterbi_scores(
    mesh: ScanMesh,
    block,  # profiles, identical on every process
    eidx: np.ndarray,
    seq_len: np.ndarray,
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    dev_block: list[Tile] | None = None,
):
    """One globally-sharded Viterbi scan step: this process's tiles,
    scored, as [(rows, cols, alt [rows, cols], null [rows, cols])] with
    rows indices into ``eidx`` and cols into ``block``; the counterpart
    of the JAX version's addressable shards.  Pass ``dev_block`` (from
    ``make_global_block``) to reuse the tiles' tables across batches.
    The scores stay on the tiles' devices, unsynchronised."""
    if dev_block is None:
        dev_block = make_global_block(mesh, block)
    eidx = np.asarray(eidx, np.int32)
    seq_len = np.asarray(seq_len, np.int32)
    shards = seq_shards(np.arange(eidx.shape[0]), mesh.seqs)
    out = []
    for t in dev_block:
        rows = np.asarray(shards[t.s], np.int64)
        if not len(rows):
            continue
        dev = t.blk.fm.device
        alt, null = vc.scores(
            t.blk, torch.from_numpy(eidx[rows]).to(dev),
            torch.from_numpy(seq_len[rows]).to(dev),
            multi_hits=multi_hits, hmmer3_compat=hmmer3_compat,
        )
        out.append((rows, t.cols, alt, null))
    return out


def parity_fixture(nprofiles: int = 8, nseqs: int = 6, core: int = 5,
                   seq_len: int = 40):
    """(profiles, eidx [nseqs, seq_len, 5], seq_len [nseqs]): the JAX
    version's worker_parity_check fixture, on its seed (7)."""
    from deciphon_tpu_torch.models.alphabet import DNA
    from deciphon_tpu_torch.models.h3reader import build_profile
    from deciphon_tpu_torch.models.h3writer import random_h3
    from deciphon_tpu_torch.ops.emissions import fragment_indices
    from deciphon_tpu_torch.ops.viterbi_torch import end_fragment_indices

    rng = np.random.default_rng(7)
    profiles = [
        build_profile(random_h3(s + 1, core, peak=0.8))
        for s in range(nprofiles)
    ]
    seqs = ["".join(rng.choice(list("ACGT"), seq_len)) for _ in range(nseqs)]
    eidx = np.stack([
        end_fragment_indices(fragment_indices(DNA.encode(s), pad_to=seq_len))
        for s in seqs
    ])
    return profiles, eidx, np.array([len(s) for s in seqs], np.int32)


def worker_parity_check(
    nprofiles: int = 8, nseqs: int = 6, core: int = 5, seq_len: int = 40,
    profile_axis: int | None = None, device: str = "cuda",
):
    """Run one globally-sharded scan step on ``parity_fixture`` and assert
    that every local tile matches the unsharded single-process scores
    (the plain version on the CPU) within atol 1e-5; then a barrier.
    Called inside an initialized process group (every process runs it);
    returns (seconds, cells) for throughput accounting."""
    from deciphon_tpu_torch.ops import viterbi_torch as vt

    profiles, eidx, slen = parity_fixture(nprofiles, nseqs, core, seq_len)
    mesh = global_scan_mesh(profile_axis, device)
    dev_block = make_global_block(mesh, profiles)
    t0 = time.perf_counter()
    tiles = global_viterbi_scores(mesh, profiles, eidx, slen,
                                  dev_block=dev_block)
    host = [(r, c, a.cpu().numpy(), n.cpu().numpy()) for r, c, a, n in tiles]
    dt = time.perf_counter() - t0

    ref_alt, ref_null = (t.numpy() for t in vt.viterbi_scores(
        vt.build_profile_block(profiles), eidx, slen))
    checked = 0
    for rows, cols, alt, null in host:
        for got, ref in ((alt, ref_alt), (null, ref_null)):
            np.testing.assert_allclose(got, ref[np.ix_(rows, cols)],
                                       atol=1e-5)
            checked += got.size
    if not checked:
        raise AssertionError(f"rank {dist.get_rank()} holds no tile")
    dist.barrier()
    cells = float(nseqs) * nprofiles * seq_len * core * 3
    return dt, cells
