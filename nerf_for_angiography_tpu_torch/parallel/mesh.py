"""Device-mesh helpers for ray-batch data parallelism (port of
``nerf_for_angiography_tpu/parallel/mesh.py``).

The JAX package is single-controller SPMD: one process sees every chip and
``jit`` over a ``Mesh`` computes the global batch. The port runs one process
a card under ``torch.distributed``: a 1-D ``DeviceMesh`` over the world, the
~50k-parameter MLP, the grids and the ray store replicated on every rank,
each rank's share of the per-step ray batch a contiguous slice, and the
reductions explicit collectives (``parallel/collectives.py``). Tensors stay
plain local tensors, not DTensors: the kernels are bound through ``ctypes``
and take raw pointers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def tree_map(fn, tree):
    """``fn`` applied to every tensor of ``tree`` (NamedTuples, tuples,
    lists and dicts of tensors); other leaves, None among them, pass
    through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def _world_device_type() -> str:
    """'cuda' under NCCL, 'cpu' under gloo: the device the group's
    collectives take."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(n_devices: int | None = None, axis: str = "data"):
    """1-D mesh over every rank of the initialized process group
    (``parallel.initialize_multihost``). ``n_devices``, when given, must be
    the world size: each process drives one card, so a mesh over fewer
    ranks would leave processes outside it."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "parallel.initialize_multihost() first (or run under torchrun)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans every rank: n_devices={n_devices}, world size {world}")
    return init_device_mesh(_world_device_type(), (world,), mesh_dim_names=(axis,))


def data_sharding(mesh, axis: str = "data") -> tuple:
    """Placements of a tensor whose leading (ray) axis is sharded over the
    mesh."""
    from torch.distributed.tensor import Shard

    _check_axis(mesh, axis)
    return (Shard(0),)


def replicated(mesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    del mesh
    return (Replicate(),)


def _check_axis(mesh, axis: str) -> None:
    if mesh.mesh_dim_names != (axis,):
        raise ValueError(f"the mesh's axes are {mesh.mesh_dim_names}, not ({axis!r},)")


def mesh_coords(mesh) -> tuple[int, int]:
    """(this rank's index on the mesh, the mesh's size); (0, 1) without a
    mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(), mesh.size()


def shard_bounds(n: int, rank: int, world: int) -> tuple[int, int]:
    """[start, stop) of rank ``rank``'s contiguous share of ``n`` rows:
    the first ``n % world`` ranks take one row more. Per-rank shapes need
    not agree (each rank launches its own kernels), so nothing is padded."""
    return n * rank // world, n * (rank + 1) // world


def shard_leading_axis(tree, mesh, axis: str = "data"):
    """This rank's contiguous slice of the leading axis of every tensor in
    ``tree`` (a tensor, or NamedTuples, tuples, lists and dicts of them);
    the sizes must divide over the mesh (pad with ``pad_to_multiple``)."""
    _check_axis(mesh, axis)
    rank, world = mesh_coords(mesh)

    def take(x):
        n = x.shape[0]
        if n % world:
            raise ValueError(f"leading axis {n} does not divide over {world} ranks")
        per = n // world
        return x[rank * per:(rank + 1) * per]

    return tree_map(take, tree)


def replicate(tree, mesh):
    """Every tensor of ``tree`` as rank 0 holds it, on every rank (a
    broadcast from the mesh's first rank into a copy)."""
    from . import collectives

    def bcast(x):
        out = x.clone().contiguous()
        collectives.broadcast_(out, mesh)
        return out

    return tree_map(bcast, tree)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
