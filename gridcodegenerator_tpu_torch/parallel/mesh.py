"""Device meshes over ``torch.distributed`` ranks for the multi-device layer.

The counterpart of ``gridcodegenerator_tpu/parallel/mesh.py``. A mesh is a
named grid of ranks, one device each: the scenario axis is the
data-parallel axis ("dp"), the knot axis ("kp") carries the knot-sharded
Riccati reduce (``parallel/knot_riccati.py``). Ranks are laid out
row-major with the first axis outermost, so on a ("dp", "kp") mesh each kp
group is a run of consecutive ranks: one host under ``torchrun``, whose
ranks are numbered host by host. The only traffic across kp groups in the
scenario step is the consensus reduce, a few hundred bytes a step; the
log-depth point-to-point rounds of the Riccati reduce stay inside a group.

Every group a collective may need (each non-empty set of axes, for this
rank's coordinates) is made when the mesh is built, since
``dist.new_group`` must be called by every rank in the same order. The
backend follows the device: NCCL for ``"cuda"``, gloo for ``"cpu"``; gloo
on CUDA tensors only where the caller asks for it (the collectives then
stage through host memory, ``collectives.STAGED``). NCCL refuses two ranks
on one device, so a mesh asked to run NCCL over ranks that share a device
raises instead of switching backends.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import socket
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}
Axes = Union[str, Sequence[str]]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: str = "cuda",
                           timeout_s: Optional[float] = None) -> None:
    """Join the process group once per process, before any mesh is built.

    With no arguments it reads the environment ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); otherwise
    pass the coordinator's ``host:port`` (or an ``init_method`` URL such as
    ``file:///path``), the number of processes and this one's rank. The
    backend defaults to the device's (NCCL on ``"cuda"``, gloo on
    ``"cpu"``). Does nothing when the group is already initialized, so
    library code may call it defensively."""
    if dist.is_initialized():
        return
    kw = {}
    if coordinator_address is None:
        kw["init_method"] = "env://"
    elif "://" in coordinator_address:
        kw["init_method"] = coordinator_address
    else:
        kw["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend or BACKEND_OF[torch.device(device).type],
                            **kw)


def local_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """This rank's device: a bare ``"cuda"`` means the card of the local
    rank (``LOCAL_RANK``, as ``torchrun`` sets it, modulo the cards)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device; pass "
                           "device='cpu' for the CPU")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One rank's view of a set of mesh axes: the process group over the
    ranks that share its coordinates on the other axes, those ranks in
    the axes' row-major order, and this rank's place among them."""
    group: object
    ranks: Tuple[int, ...]
    index: int
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """A named grid of ranks (``ranks``: an integer array of global ranks,
    one axis per name). Build it on every rank of the world with the same
    arguments: a rank outside the grid takes part in making its groups
    and can run none of its collectives."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device: Union[str, torch.device] = "cuda",
                 backend: Optional[str] = None):
        if not dist.is_initialized():
            raise RuntimeError("build a mesh after initialize_distributed()")
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-d ranks for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.ranks = ranks
        self.device = local_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.backend = backend or BACKEND_OF[self.device.type]
        self.rank = dist.get_rank()
        hit = np.argwhere(ranks == self.rank)
        self.coords = (dict(zip(self.axis_names, map(int, hit[0])))
                       if len(hit) else None)
        self._groups = {}
        nd = len(self.axis_names)
        for k in range(1, nd + 1):
            for sub in itertools.combinations(range(nd), k):
                rest = [a for a in range(nd) if a not in sub]
                rows = np.transpose(ranks, rest + list(sub)).reshape(
                    -1, int(np.prod([ranks.shape[a] for a in sub])))
                for row in rows:
                    row = tuple(int(r) for r in row)
                    if list(row) != sorted(row):
                        raise ValueError("a mesh's ranks must increase "
                                         "along every axis")
                    g = dist.new_group(list(row), backend=self.backend)
                    if self.rank in row:
                        names = tuple(self.axis_names[a] for a in sub)
                        self._groups[names] = AxisGroup(
                            g, row, row.index(self.rank), self.backend)
        if self.backend == "nccl":
            self._check_devices_distinct()

    def _check_devices_distinct(self):
        """NCCL runs one rank a device: raise where two ranks of the mesh
        share one (over a gloo group made for this check alone)."""
        probe = dist.new_group(sorted(int(r) for r in self.ranks.flat),
                               backend="gloo")
        if self.coords is None:
            return
        uuid = str(getattr(torch.cuda.get_device_properties(self.device),
                           "uuid", self.device.index))
        seen = [None] * self.ranks.size
        dist.all_gather_object(seen, (socket.gethostname(), uuid),
                               group=probe)
        if len(set(seen)) != len(seen):
            raise RuntimeError(
                f"NCCL runs one rank a device, and ranks of this mesh share "
                f"one ({seen}); build the mesh with backend='gloo' to run "
                f"them on one card")

    def _names(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} of a mesh over {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis(self, axes: Axes) -> AxisGroup:
        """This rank's group over ``axes`` (a name or several)."""
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in this mesh")
        return self._groups[self._names(axes)]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("dp",),
              shape: Optional[Tuple[int, ...]] = None,
              device: Union[str, torch.device] = "cuda",
              backend: Optional[str] = None) -> Mesh:
    """A mesh over the first ``n_devices`` ranks (default: all), by default
    all of them on the first axis."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"{n} devices of a world of {world}")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    return Mesh(np.arange(n).reshape(shape), axis_names, device, backend)


def make_hybrid_mesh(axis_names: Tuple[str, ...] = ("dp", "kp"),
                     kp_size: int = 1,
                     n_devices: Optional[int] = None,
                     device: Union[str, torch.device] = "cuda",
                     backend: Optional[str] = None) -> Mesh:
    """The 2-axis mesh ("dp", "kp") with dp outermost: each kp group is
    ``kp_size`` consecutive ranks. Under ``torchrun`` (``LOCAL_WORLD_SIZE``
    set) a kp group must fit within one host."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if kp_size < 1 or n % kp_size:
        raise ValueError(f"{n} devices do not split into kp groups of "
                         f"{kp_size}")
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if per_host % kp_size and n_devices is None:
        raise ValueError(f"the kp axis ({kp_size}) must fit within one host "
                         f"({per_host} ranks)")
    return make_mesh(n, axis_names, (n // kp_size, kp_size), device, backend)


def _shard_index(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's row-major index over ``axes``, the number of shards)."""
    idx, count = 0, 1
    for a in mesh.axis_names:
        if a in axes:
            idx = idx * mesh.shape[a] + mesh.coords[a]
            count *= mesh.shape[a]
    return idx, count


def shard_along(x: torch.Tensor, mesh: Mesh, dim: int,
                axes: Optional[Axes] = None) -> torch.Tensor:
    """This rank's slice of the global ``x`` along ``dim``, split over
    ``axes`` jointly (default: every axis of the mesh), as a ``shard_map``
    body would see it. The counterpart of ``dp_sharding``."""
    if mesh.coords is None:
        raise RuntimeError(f"rank {mesh.rank} is not in this mesh")
    names = mesh._names(mesh.axis_names if axes is None else axes)
    idx, count = _shard_index(mesh, names)
    if x.shape[dim] % count:
        raise ValueError(f"size {x.shape[dim]} does not split over {names} "
                         f"({count} shards)")
    step = x.shape[dim] // count
    return x.narrow(dim, idx * step, step).contiguous()


def gather_along(x: torch.Tensor, mesh: Mesh, dim: int,
                 axes: Optional[Axes] = None) -> torch.Tensor:
    """The inverse of :func:`shard_along`: every rank's slice over ``axes``
    joined along ``dim``, on every rank."""
    from .collectives import all_gather
    names = mesh._names(mesh.axis_names if axes is None else axes)
    return all_gather(x, mesh.axis(names), dim)
