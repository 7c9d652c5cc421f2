"""The collectives of the multi-device layer, over a mesh's axis groups.

The counterparts of the ``jax.lax`` collectives the JAX package's
multi-device layer calls inside ``shard_map``: ``psum`` and ``pmin`` over a
set of axes, ``ppermute`` i -> i - k along one axis, and the tiled
``all_gather`` along the knot axis. Each takes an ``AxisGroup``
(``Mesh.axis(...)``).

gloo moves host tensors only (its point-to-point calls and all_gather take
no CUDA tensor), so where a gloo group carries CUDA tensors every call
copies them to host memory and back: ``STAGED`` counts the bytes copied,
both ways, and ``STAGED_SECONDS`` the host seconds of each such call
(copies and exchange, the card synchronized first, so the kernels before
it are not counted), by collective. NCCL moves them on the card. Every
tensor handed to the backend is contiguous.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import AxisGroup

# bytes copied between the card and host memory, and host seconds of the
# calls that copied them, by collective
STAGED = collections.Counter()
STAGED_SECONDS = collections.Counter()


def reset_staged():
    STAGED.clear()
    STAGED_SECONDS.clear()


@contextlib.contextmanager
def _wire(like: torch.Tensor, ax: AxisGroup, what: str):
    """Yield the device the backend moves ``like`` on (the host for gloo)
    and time the call where that is a copy away."""
    if ax.backend != "gloo" or not like.is_cuda:
        yield like.device
        return
    torch.cuda.synchronize(like.device)
    t = time.perf_counter()
    yield torch.device("cpu")
    STAGED_SECONDS[what] += time.perf_counter() - t


def _move(x: torch.Tensor, device: torch.device, what: str) -> torch.Tensor:
    """``x`` contiguous on ``device``, its bytes counted if it moved."""
    x = x.contiguous()
    if x.device != device:
        STAGED[what] += x.numel() * x.element_size()
        return x.to(device)
    return x


def _reduce(x: torch.Tensor, ax: AxisGroup, op, what: str) -> torch.Tensor:
    with _wire(x, ax, what) as wire:
        y = _move(x, wire, what)
        if y.device == x.device:     # all_reduce works in place
            y = y.clone()
        dist.all_reduce(y, op=op, group=ax.group)
        return _move(y, x.device, what)


def psum(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``ax``, on each of them."""
    return _reduce(x, ax, dist.ReduceOp.SUM, "psum")


def pmin(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the ranks of ``ax``."""
    return _reduce(x, ax, dist.ReduceOp.MIN, "pmin")


def ppermute(xs: Sequence[torch.Tensor], ax: AxisGroup,
             k: int) -> Optional[List[torch.Tensor]]:
    """Send the tensors ``xs`` from axis index i to i - k, for every i >= k,
    and return those received from i + k: None on the ranks with no source
    (i + k past the axis), where ``jax.lax.ppermute`` delivers zeros.
    The tensors travel packed in one buffer, one message a rank."""
    i, D = ax.index, ax.size
    dst = i - k if i - k >= 0 else None
    src = i + k if i + k < D else None
    like = xs[0]
    with _wire(like, ax, "ppermute") as wire:
        reqs, buf = [], None
        if dst is not None:
            out = _move(torch.cat([x.reshape(-1) for x in xs]), wire,
                        "ppermute")
            reqs.append(dist.isend(out, ax.ranks[dst], group=ax.group))
        if src is not None:
            buf = torch.empty(sum(x.numel() for x in xs), dtype=like.dtype,
                              device=wire)
            reqs.append(dist.irecv(buf, ax.ranks[src], group=ax.group))
        for req in reqs:
            req.wait()
        if buf is None:
            return None
        flat = _move(buf, like.device, "ppermute")
    got, at = [], 0
    for x in xs:
        got.append(flat[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return got


def all_gather(x: torch.Tensor, ax: AxisGroup, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``ax`` joined along ``dim`` in axis order (the
    tiled ``jax.lax.all_gather``), on each of them."""
    with _wire(x, ax, "all_gather") as wire:
        y = _move(x, wire, "all_gather")
        parts = [torch.empty_like(y) for _ in range(ax.size)]
        dist.all_gather(parts, y, group=ax.group)
        return _move(torch.cat(parts, dim=dim), x.device, "all_gather")
