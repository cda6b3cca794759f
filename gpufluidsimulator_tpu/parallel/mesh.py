"""Device mesh construction.

Reference counterpart: none — the reference is single-GPU with no NCCL/MPI
(SURVEY.md §2 "Distributed communication backend").  This rebuild scales by
spatial domain decomposition: the spatial grid is sharded across a device
mesh with halo exchange of ghost particles via jax.lax.ppermute (NCCL on
GPUs).

A 1D mesh along the simulation x axis is the algorithm's choice: halo and
migration traffic only goes to the two x neighbours, and each device's x
slab keeps the plane layout's 128-lane x tiles intact.  (The cards of one
host are joined all to all, so the mesh need not follow any topology.)
Multi-host meshes come through jax.distributed + the same Mesh API.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "x"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Multi-host (DCN) entry point: initialize the JAX distributed runtime.

    Call ONCE per process, before any other jax API, when the mesh spans
    hosts (SURVEY.md §5.8: cross-host transport via ``jax.distributed``;
    the devices of one host need no extra setup).  Arguments default to
    the environment:

      FLUID_COORDINATOR   host:port of process 0's coordinator service
      FLUID_NUM_PROCESSES total process count
      FLUID_PROCESS_ID    this process's rank

    Returns True when the distributed runtime was initialized (multi-process
    run), False for the single-process no-op — so callers can do
    ``init_distributed(); mesh = make_mesh()`` unconditionally:
    ``jax.devices()`` then enumerates the GLOBAL device set and the same
    shard_map programs run unchanged (tested with two local CPU processes,
    tests/test_multihost.py).
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("FLUID_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("FLUID_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("FLUID_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1D mesh over the first n available devices (default: all)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    import numpy as np
    return Mesh(np.asarray(devices), (AXIS,))


def shard_leading(mesh: Mesh):
    """Sharding that splits the leading (device) axis of a stacked array."""
    return NamedSharding(mesh, P(AXIS))
