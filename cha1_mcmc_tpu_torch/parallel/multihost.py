"""Process-group start-up and deterministic work assignment across hosts.

Port of cha1_mcmc_tpu/parallel/multihost.py. The scaling layout: walkers
and catalog lines shard across the cards of a run (parallel/sharded.py);
*independent* work — separate molecules, or independent chains of one
molecule — distributes across hosts, with no communication between them
during sampling.

`initialize_multihost` starts torch.distributed from a launcher's
environment (torchrun's RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and
LOCAL_RANK) or from an explicit address; with neither it is the
single-process case, as the JAX version treats a failed auto-detect.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "host_molecule_assignment", "local_rank"]

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def local_rank() -> int:
    """This process's card on its host: the launcher's LOCAL_RANK, else 0."""
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str | None = None) -> tuple[int, int]:
    """Initialize torch.distributed and return (rank, world_size).

    coordinator_address ("host:port") with num_processes and process_id
    starts the group over TCP; otherwise the launcher's environment is
    used when it is complete. With neither, nothing is initialized and
    the result is (0, 1), the legitimate single-process case. The backend
    is NCCL where CUDA is available, gloo on the CPU, unless given. An
    already initialized group is returned as it is."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif all(v in os.environ for v in _LAUNCHER_VARS):
        dist.init_process_group(backend, init_method="env://")
    else:
        return 0, 1
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    return dist.get_rank(), dist.get_world_size()


def host_molecule_assignment(molecules, process_index: int,
                             process_count: int) -> list:
    """Deterministic round-robin assignment of molecules to hosts —
    the host-level data parallelism (independent fits, no collectives)."""
    ordered = sorted(molecules)
    return [m for i, m in enumerate(ordered) if i % process_count == process_index]
