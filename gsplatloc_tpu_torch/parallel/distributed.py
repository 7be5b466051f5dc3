"""Several processes: a gloo process group, a tile mesh across all of their
devices, and scene sharding across processes.

The counterpart of the JAX package's parallel/distributed.py:

  * WITHIN a scene: `global_tile_mesh` spans every rank's local devices in
    rank order; each rank renders its own bands, all_gathers the band
    outputs and gradient partials, and sums the partials in global band
    order (parallel/sharded.py), so every rank holds the same image, loss
    and pose, bit for bit.
  * ACROSS scenes: `shard_scenes` gives process i the scenes [i::P].

The group uses gloo: a collective moves only CPU copies of band outputs
and partials, and two ranks may share one card (NCCL refuses that). It
shows correctness, not scaling. Nothing is read from the environment:
`initialize` takes the coordinator, rank and world size as arguments and
passes them to init_process_group with a tcp:// address.
"""

from __future__ import annotations

import torch


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the gloo process group of num_processes processes, this one
    ranked process_id, rendezvousing at coordinator_address ("host:port").
    With no process count, or one, sets up nothing and returns False;
    otherwise returns True. A second call is a no-op (it returns whether a
    group of more than one process is up)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize() with several processes needs "
                         "coordinator_address and process_id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        rank=process_id, world_size=num_processes)
    return True


def global_tile_mesh(devices=None):
    """TileMesh over every rank's devices, in rank order: this process's
    bands on `devices` (default: its visible CUDA devices; raises when
    there are none), the process group's other ranks owning as many
    bands each. Without a process group: the local mesh."""
    import torch.distributed as dist

    from .sharded import TileMesh, make_tile_mesh

    if devices is None:
        devices = make_tile_mesh().devices
    group = (dist.group.WORLD if dist.is_available() and dist.is_initialized()
             else None)
    return TileMesh(devices, group=group)


def shard_scenes(scenes: list, process_id: int | None = None,
                 process_count: int | None = None) -> list:
    """Scene-level data parallelism across processes: process i takes
    scenes[i::P]. process_id / process_count default to the process
    group's rank and size when one is up, else 0 and 1."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    pid = (dist.get_rank() if up else 0) if process_id is None else process_id
    pcount = ((dist.get_world_size() if up else 1) if process_count is None
              else process_count)
    return list(scenes)[pid::pcount]
