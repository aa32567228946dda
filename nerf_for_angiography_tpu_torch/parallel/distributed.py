"""Multi-process initialization and input sharding (port of
``nerf_for_angiography_tpu/parallel/distributed.py``).

One process drives one card. ``initialize_multihost()`` joins the process
group: NCCL on the card, gloo on the CPU, with ``torchrun``'s environment
(``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) filling what the call leaves out. Afterwards
``parallel.create_mesh()`` spans every rank. ``is_coordinator()`` gates
every artifact write (checkpoints, VTK exports, TensorBoard logs, the
sweep's files): exactly one writer. ``process_local_slice`` and
``shard_process_local`` are the input-feeding half: each process feeds
only its slice of a global batch.
"""

from __future__ import annotations

import os
from collections.abc import Sequence

import torch
import torch.distributed as dist

from .mesh import tree_map

__all__ = [
    "initialize_multihost",
    "is_coordinator",
    "shard_process_local",
    "process_local_slice",
]


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: int | Sequence[int] | None = None,
    device: str | None = None,
) -> None:
    """Join the process group. Call once per process, before the first
    collective.

    ``coordinator_address`` is ``host:port`` (a TCP store on rank 0's host)
    or an init URL (``tcp://...``, ``file://...``); without it the
    environment's ``MASTER_ADDR`` / ``MASTER_PORT`` are read. The world size
    and rank default to ``WORLD_SIZE`` / ``RANK``, the card to
    ``local_device_ids`` (an index, or a sequence whose first entry is
    taken) or ``LOCAL_RANK``. ``device`` 'cuda' (the default where a card
    is visible) joins over NCCL and takes the card; 'cpu' joins over gloo."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs num_processes and process_id "
                         "(or WORLD_SIZE and RANK, as torchrun sets them)")
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError("initialize_multihost needs coordinator_address (or MASTER_ADDR "
                             "and MASTER_PORT, as torchrun sets them)")
        coordinator_address = f"{addr}:{port}"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to join over gloo")
        if isinstance(local_device_ids, Sequence):
            local_device_ids = local_device_ids[0]
        if local_device_ids is None:
            local_device_ids = _env_int("LOCAL_RANK") or 0
        torch.cuda.set_device(int(local_device_ids))
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


def is_coordinator() -> bool:
    """True on exactly one process, the artifact writer: rank 0, or the
    only process when there is no process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_local_slice(n_global: int) -> slice:
    """The contiguous slice of a leading-axis-sharded global array this
    process feeds. The per-process share must be equal (pad the batch with
    ``parallel.pad_to_multiple`` first)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_global % world:
        raise ValueError(f"global batch {n_global} does not divide over {world} processes")
    per = n_global // world
    i = dist.get_rank() if dist.is_initialized() else 0
    return slice(i * per, (i + 1) * per)


def shard_process_local(tree, mesh, axis: str = "data"):
    """The PROCESS-LOCAL shards of a leading-axis-sharded global batch:
    each process passes only its own slice (global / processes rows), and
    keeps it as it is, made contiguous; no ray crosses between processes.
    Raises unless every process passed the same number of rows. Without
    other processes this is ``parallel.shard_leading_axis`` of one rank."""
    from . import collectives

    if mesh.mesh_dim_names != (axis,):
        raise ValueError(f"the mesh's axes are {mesh.mesh_dim_names}, not ({axis!r},)")
    rows: list[int] = []
    tree_map(lambda x: rows.append(x.shape[0]), tree)
    if rows and mesh.size() > 1:
        dev = "cuda" if collectives.backend_of(mesh) == "nccl" else "cpu"
        got = collectives.all_gather_cat(
            torch.tensor([rows], dtype=torch.int64, device=dev), mesh).tolist()
        if any(r != got[0] for r in got):
            raise ValueError(f"the processes' local shards differ in rows: {got}")
    return tree_map(lambda x: x.contiguous(), tree)
