"""The collectives of the sharded paths, over a 1-D ``DeviceMesh``: the
train step's gradient all-reduce and pressure max, the sweep's and the DRR
renderer's gathers, rank 0's broadcast, and the loop's check that every
rank made the same host-side decision.

CUDA tensors go over NCCL and CPU tensors over gloo; any other pairing
raises (``check_backend``). Every call is synchronous (``async_op=False``),
so an all-reduce inside a captured train step is one node of its CUDA
graph.
"""

from __future__ import annotations

import hashlib

import torch
import torch.distributed as dist

from .mesh import mesh_coords

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def backend_of(mesh) -> str:
    return dist.get_backend(mesh.get_group())


def check_backend(device: torch.device | str, mesh) -> None:
    """Raise unless the mesh's backend serves tensors on ``device``: NCCL,
    the card's backend, for CUDA tensors, gloo for CPU tensors."""
    kind = torch.device(device).type
    backend = backend_of(mesh)
    if kind == "cuda" and backend != "nccl":
        raise RuntimeError(f"CUDA tensors under a {backend!r} process group: the port's "
                           "collectives on the card run over NCCL")
    if kind != "cuda" and backend == "nccl":
        raise RuntimeError(f"{kind} tensors under an NCCL process group: CPU runs use gloo")


def all_reduce_(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``t`` over the mesh ('sum' or 'max')."""
    check_backend(t.device, mesh)
    dist.all_reduce(t, op=_OPS[op], group=mesh.get_group())
    return t


def all_gather_cat(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along the
    leading axis in rank order, on every rank."""
    check_backend(t.device, mesh)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(parts, t, group=mesh.get_group())
    return torch.cat(parts, dim=0)


def broadcast_(t: torch.Tensor, mesh) -> torch.Tensor:
    """In-place broadcast of the mesh's first rank's ``t``."""
    check_backend(t.device, mesh)
    group = mesh.get_group()
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t


def agree(mesh, decisions: dict, where: str) -> None:
    """Raise unless every rank holds the same ``decisions`` (a dict of host
    values: the Tuning, a pressure fire, the best checkpoint, the stop).
    One all-gather of a 64-bit hash of their repr; a rank that went its
    own way would otherwise hang at the next collective."""
    digest = hashlib.sha1(repr(sorted(decisions.items())).encode()).digest()
    h = int.from_bytes(digest[:8], "little", signed=True)
    dev = (torch.device("cuda", torch.cuda.current_device()) if backend_of(mesh) == "nccl"
           else torch.device("cpu"))
    got = all_gather_cat(torch.tensor([h], dtype=torch.int64, device=dev), mesh).tolist()
    if len(set(got)) != 1:
        rank, _ = mesh_coords(mesh)
        raise RuntimeError(f"the ranks' host decisions differ at {where}: rank {rank} holds "
                           f"{decisions}; the ranks' hashes {got}")
