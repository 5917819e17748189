"""Device meshes and the collectives of scale-out.

Counterpart of the JAX package's ``Mesh`` and the collectives its
``shard_map`` bodies call. Here the program is SPMD over processes, one
per device (``torchrun --nproc-per-node N``, or any launcher that
initialises ``torch.distributed``), and a
``torch.distributed.device_mesh.DeviceMesh`` with named dims ("region",
"batch", "az") stands in for the JAX mesh. Every rank calls the same
entry with the same arguments; each computes its own coordinates' share
and the collectives below assemble the result on every rank:

=================  ==========================================
JAX                here
=================  ==========================================
``ppermute``       ``ring_halo``: ``batch_isend_irecv`` on a ring
``pmax``           ``all_reduce(..., MAX)``
``psum``           ``all_reduce(..., SUM)``
disjoint shards    ``all_gather``: gathered and concatenated
=================  ==========================================

The backend follows the tensors' device: NCCL for CUDA tensors, gloo for
CPU tensors. A collective checks its group's backend against its tensor
and raises on a mismatch; nothing falls back to another backend.

With no process group initialised, ``resolve_mesh("auto")`` (or a size of
1) makes a one-rank group on an in-process ``HashStore``, the JAX
package's "every visible device" on one device: the collectives still
run, so one code path serves every mesh size. A larger mesh needs a
process group that the launcher made.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["all_gather", "all_reduce", "backend_for", "coord",
           "dim_size", "ensure_group", "resolve_mesh", "ring_halo",
           "sum_over_mesh"]


def backend_for(device) -> str:
    """The backend that carries tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_backend(device, group=None):
    have = str(dist.get_backend(group))
    want = backend_for(device)
    if want not in have:
        raise ValueError(
            f"{torch.device(device).type} tensors take the {want} backend, "
            f"but this process group's backend is {have!r}: initialise the "
            f"group with backend={want!r} for tensors on this device")


def ensure_group(device):
    """The default process group: a one-rank group on an in-process
    HashStore when none is initialised. Checks that its backend carries
    tensors on ``device``."""
    device = torch.device(device)
    if not dist.is_initialized():
        kw = {}
        if device.type == "cuda":
            kw["device_id"] = torch.device(
                "cuda", torch.cuda.current_device() if device.index is None
                else device.index)
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                rank=0, world_size=1, **kw)
    _check_backend(device)


# meshes made here, by (spec, dims, device type, world group): making one
# creates its dims' process groups, a collective of every rank
_MESHES: dict = {}


def resolve_mesh(spec, dims, device) -> DeviceMesh:
    """A DeviceMesh with the named ``dims`` from ``spec``: "auto" (every
    rank on the first dim, size 1 on the others), an int (that many ranks,
    the whole world), or a DeviceMesh. A DeviceMesh must name the first
    dim; one that names only the first gets the others added at size 1
    (the JAX package's batch-only mesh). Without a process group only a
    one-rank mesh can be made: a larger one raises, naming torchrun. Meshes
    made here are kept and made once."""
    device = torch.device(device)
    dims = tuple(dims)
    if isinstance(spec, DeviceMesh):
        names = tuple(spec.mesh_dim_names or ())
        if dims[0] not in names:
            raise ValueError(f"the mesh needs a {dims[0]!r} dim, got "
                             f"{names}")
        _check_backend(device)
        if all(d in names for d in dims):
            return spec
        if names != dims[:1]:
            raise ValueError(f"a mesh of dims {names} for dims {dims}")
        key = (id(spec), dims)
        if key not in _MESHES:
            shape = (-1,) + (1,) * (len(dims) - 1)
            _MESHES[key] = (spec, DeviceMesh(
                spec.device_type, spec.mesh.reshape(shape),
                mesh_dim_names=dims))
        return _MESHES[key][1]
    if spec == "auto":
        size = dist.get_world_size() if dist.is_initialized() else 1
    elif isinstance(spec, int) and not isinstance(spec, bool) and spec > 0:
        size = spec
    else:
        raise ValueError(f"a mesh is 'auto', a positive int or a "
                         f"DeviceMesh, got {spec!r}")
    if not dist.is_initialized() and size != 1:
        raise ValueError(
            f"a mesh of {size} ranks needs a process group: run one process "
            f"per device (torchrun --nproc-per-node {size} ...), or pass "
            f"'auto' or 1 for this process alone")
    ensure_group(device)
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"a mesh of {size} ranks in a world of {world}: "
                         f"pass 'auto' or a DeviceMesh")
    key = (dims, device.type, dist.group.WORLD)
    if key not in _MESHES:
        shape = (world,) + (1,) * (len(dims) - 1)
        _MESHES[key] = DeviceMesh(device.type,
                                  torch.arange(world).reshape(shape),
                                  mesh_dim_names=dims)
    return _MESHES[key]


def dim_size(mesh, dim: str | None) -> int:
    """The ranks along ``dim`` (1 for None) of a DeviceMesh, or of a mesh
    shape given as {dim name: size} (the entries' local functions take
    one, to drive every coordinate of a larger mesh in one process)."""
    if dim is None:
        return 1
    if isinstance(mesh, dict):
        return mesh[dim]
    return mesh.size(mesh.mesh_dim_names.index(dim))


def coord(mesh: DeviceMesh, dim: str | None) -> int:
    """This rank's index along ``dim`` (0 for None)."""
    return 0 if dim is None else mesh.get_local_rank(dim)


def ring_halo(tensors, mesh: DeviceMesh, dim: str):
    """The ring halo exchange (the JAX ppermute i -> i - 1): each rank along
    ``dim`` sends ``tensors`` to its predecessor and returns what its
    successor sent; the last rank returns zeros (its halo lies past the
    grid and is masked by the caller, regions.py:97-103). At one rank
    nothing is sent."""
    r, idx = dim_size(mesh, dim), coord(mesh, dim)
    group = mesh.get_group(dim)
    for t in tensors:
        _check_backend(t.device, group)
    recv = [torch.zeros_like(t) for t in tensors]
    if r == 1:
        return recv
    ranks = dist.get_process_group_ranks(group)
    ops = []
    for tag, (t, rv) in enumerate(zip(tensors, recv)):
        # a tag each: two messages between one pair of ranks must not be
        # matched by arrival
        ops.append(dist.P2POp(dist.isend, t.contiguous(),
                              ranks[(idx - 1) % r], group, tag))
        ops.append(dist.P2POp(dist.irecv, rv, ranks[(idx + 1) % r], group,
                              tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if idx == r - 1:
        for rv in recv:
            rv.zero_()
    return recv


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, dim: str,
               op=dist.ReduceOp.MAX) -> torch.Tensor:
    """``x`` reduced in place over the ranks along ``dim``."""
    group = mesh.get_group(dim)
    _check_backend(x.device, group)
    dist.all_reduce(x, op=op, group=group)
    return x


def sum_over_mesh(x: torch.Tensor, mesh: DeviceMesh, dims) -> torch.Tensor:
    """``x`` summed in place over every rank of the named ``dims``."""
    for d in dims:
        all_reduce(x, mesh, d, dist.ReduceOp.SUM)
    return x


def all_gather(x: torch.Tensor, mesh: DeviceMesh, dim: str,
               axis: int) -> torch.Tensor:
    """The shards of the ranks along ``dim``, in rank order, concatenated
    on ``axis``."""
    r = dim_size(mesh, dim)
    group = mesh.get_group(dim)
    _check_backend(x.device, group)
    if r == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(r)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)
