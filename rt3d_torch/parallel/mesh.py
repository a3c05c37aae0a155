"""Device meshes and the parameter sharding rule (port of
`rt3d/parallel/mesh.py`) over `torch.distributed`'s `DeviceMesh`.

The FSDP rule is the JAX package's, applied to each parameter in the JAX
layout's order of dimensions: the port keeps conv kernels OIHW (the
prototype upsample IOHW) where JAX keeps them HWIO, so on equal sizes the
first dimension differs (a (3, 3, 64, 64) kernel shards I in JAX; read
in OIHW order the same rule would shard O). The chosen JAX dimension is
mapped back to the port's layout, so both packages shard the same logical
axis of every parameter.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

# where each dimension of a port weight sits in the JAX package's kernel
# (kh, kw, I, O): port dim i is JAX dim _PERM[i]
_CONV_PERM = (3, 2, 0, 1)      # OIHW
_UPSAMPLE_PERM = (2, 3, 0, 1)  # IOHW (ConvTranspose)


def make_mesh(axis_sizes: Dict[str, int], device_type: str = "cuda") -> DeviceMesh:
    """A mesh with named axes over the initialized process group's ranks,
    e.g. {'dp': 2, 'fsdp': 2}, in rank order (the last axis the minor one,
    so put the chattiest axis last, as in the JAX package). It spans the
    whole group: a mesh that needs more ranks than the group has fails
    with the JAX package's message, one that needs fewer fails too (the
    JAX package would take the first devices)."""
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes.values())
    need = int(np.prod(sizes))
    have = dist.get_world_size()
    if need > have:
        raise ValueError(f"mesh needs {need} devices, have {have}")
    if need < have:
        raise ValueError(f"mesh of {need} devices on a process group of {have}: "
                         "start the group with the mesh's size")
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def fsdp_dim(shape: Sequence[int], size: int) -> Optional[int]:
    """The JAX package's rule on one shape: the largest dimension divisible
    by `size` and at least as large, the first on equal sizes; None for a
    scalar or when no dimension fits (replicate)."""
    best, best_dim = None, -1
    for d, n in enumerate(shape):
        if n % size == 0 and n >= size and n > best_dim:
            best, best_dim = d, n
    return best


def jax_order(name: str, ndim: int) -> Tuple[int, ...]:
    """Port dim i of parameter `name` is dim ``jax_order(...)[i]`` of the
    JAX package's array (biases and other vectors keep their order)."""
    if ndim == 4 and name.endswith("weight"):
        return _UPSAMPLE_PERM if name.rsplit(".", 2)[-2] == "upsample" else _CONV_PERM
    return tuple(range(ndim))


def fsdp_placements(model: nn.Module, size: int) -> Dict[str, Placement]:
    """The counterpart of `fsdp_param_shardings` for an fsdp axis of `size`
    ranks: per parameter name, `Shard(d)` on the port dimension that holds
    the JAX dimension the rule picks, or `Replicate()`."""
    out = {}
    for name, p in model.named_parameters():
        perm = jax_order(name, p.ndim)
        jshape = [0] * p.ndim
        for i, j in enumerate(perm):
            jshape[j] = p.shape[i]
        best = fsdp_dim(jshape, size)
        out[name] = Replicate() if best is None else Shard(perm.index(best))
    return out


def replicated(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """Placements of a tensor held whole on every rank of `mesh`."""
    return (Replicate(),) * mesh.ndim


def batch_sharding(mesh: DeviceMesh,
                   axis: Union[str, Sequence[str]] = "dp") -> Tuple[Placement, ...]:
    """Placements of a batch split on its leading axis over `axis`, one
    mesh axis or several (JAX's ``P(("dp", "fsdp"))``, split in mesh
    order)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(Shard(0) if n in axes else Replicate() for n in mesh.mesh_dim_names)


def local_part(full: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence[Placement]) -> torch.Tensor:
    """This rank's part of the whole tensor `full` laid out on `mesh` by
    `placements`: each `Shard(d)` splits dimension d as `torch.chunk`
    does (as `DTensor` and FSDP2 split it), in mesh order; a rank past the
    last chunk holds an empty one."""
    for dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, j = mesh.size(dim), mesh.get_local_rank(dim)
            chunks = torch.chunk(full, n, dim=pl.dim)
            full = chunks[j] if j < len(chunks) else full.narrow(pl.dim, 0, 0)
    return full
