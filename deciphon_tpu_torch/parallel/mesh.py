"""Device mesh for scans over several torch devices.

The counterpart of deciphon_tpu/parallel/mesh.py.  The scan's two data
axes map onto a 2-D grid of devices:

  'profiles' — shards each engine block's profiles (the tensor analogue
      of the reference's <=64 contiguous DB partitions,
      src/db/profile_reader.c);
  'seqs'    — data-parallel over the read batch.

There is no jax.sharding.Mesh here: the grid is a plain row-major list
of torch devices, [seqs, profiles].  A device may appear more than once
(["cuda:0"] * 4 on one card, ["cpu"] * 8 in the tests): every tile still
holds its own tables and writes its own outputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ScanMesh:
    """A [seqs, profiles] grid of torch devices, row-major."""

    devices: tuple[torch.device, ...]
    seqs: int
    profiles: int

    @property
    def shape(self) -> dict[str, int]:
        return {"seqs": self.seqs, "profiles": self.profiles}

    def device(self, s: int, p: int) -> torch.device:
        """The device of tile (read shard ``s``, profile shard ``p``)."""
        return self.devices[s * self.profiles + p]


def make_scan_mesh(
    profile_axis: int | None = None,
    seq_axis: int | None = None,
    devices=None,
) -> ScanMesh:
    """Mesh over ``devices`` (default: every visible ``cuda:i``), with
    the JAX package's axis choice: favour sequence data-parallelism and
    shard profiles on the rest."""
    if devices is None:
        devices = [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        ]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("mesh over 0 devices")
    if profile_axis is None and seq_axis is None:
        seq_axis = 1
        while seq_axis * 2 <= n and (n // (seq_axis * 2)) * (seq_axis * 2) == n:
            seq_axis *= 2
        profile_axis = n // seq_axis
    elif profile_axis is None:
        profile_axis = n // seq_axis
    elif seq_axis is None:
        seq_axis = n // profile_axis
    if profile_axis * seq_axis != n:
        raise ValueError(
            f"mesh {profile_axis}x{seq_axis} != {n} devices"
        )
    return ScanMesh(tuple(devices), seq_axis, profile_axis)
