"""A group of local ranks that run functions on request, each with a time
limit.

``RankGroup(world_size, init_method, backend)`` starts ``world_size``
processes with the ``spawn`` method (CUDA does not survive ``fork``), each a
rank of one process group, and keeps them until it is closed; ``run(fn,
*args)`` calls ``fn(*args)`` on every rank and returns their results in
rank order. ``fn`` must be a module-level function of a module the ranks
can import; tensors in its results come back as numpy arrays.

Nothing waits without a limit: the process group has a timeout, and a call
that does not return in time, or that raises on any rank, kills every rank
and raises, so a rank that fails cannot leave the others waiting on a
collective.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection as mp_connection
import pickle
import time
import traceback

import torch
import torch.distributed as dist


def _host(obj):
    """``obj`` with every tensor as a numpy array (the pipe carries no
    tensor storage)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, world_size, init_method, backend, timeout_s, conn):
    torch.set_num_threads(1)      # ranks share the host's cores
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        conn.send(("ok", None))
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        try:
            msg = pickle.loads(conn.recv_bytes())
        except EOFError:          # the parent is gone
            break
        except Exception:         # fn's module did not import
            conn.send(("err", traceback.format_exc()))
            continue
        if msg is None:
            break
        try:
            fn, args = msg
            conn.send(("ok", _host(fn(*args))))
        except Exception:
            conn.send(("err", traceback.format_exc()))
    dist.destroy_process_group()


class RankGroup:
    """``world_size`` spawned ranks of one process group (``init_method``:
    e.g. ``file:///a/new/file``, or ``tcp://localhost:<port>``)."""

    def __init__(self, world_size: int, init_method: str,
                 backend: str = "gloo", timeout_s: float = 60.0):
        self.world_size = world_size
        self.timeout_s = timeout_s
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for rank in range(world_size):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                rank, world_size, init_method, backend, timeout_s, child))
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self._collect("starting the process group", timeout_s)

    def _collect(self, what: str, timeout_s: float):
        """Every rank's answer, or raise (killing the ranks) at the first
        error or when the time is out."""
        deadline = time.monotonic() + timeout_s
        results, waiting = [None] * self.world_size, dict(
            zip(self._conns, range(self.world_size)))
        error = None
        while waiting and error is None:
            left = deadline - time.monotonic()
            ready = mp_connection.wait(list(waiting), max(left, 0.0))
            if not ready:
                error = (f"ranks {sorted(waiting.values())}: no answer in "
                         f"{timeout_s} s")
            for conn in ready:
                rank = waiting.pop(conn)
                try:
                    status, value = conn.recv()
                except (EOFError, OSError):
                    status, value = "err", "the rank exited\n"
                if status == "ok":
                    results[rank] = value
                elif error is None:
                    error = f"rank {rank}: {value}"
        if error is not None:
            self.close(kill=True)
            raise RuntimeError(f"{what} failed:\n{error}")
        return results

    def run(self, fn, *args, timeout_s: float = None):
        """``fn(*args)`` on every rank -> [rank 0's result, ...]."""
        if not self._procs:
            raise RuntimeError("the rank group is closed")
        for conn in self._conns:
            conn.send((fn, args))
        return self._collect(getattr(fn, "__name__", str(fn)),
                             timeout_s or self.timeout_s)

    def close(self, kill: bool = False):
        """Stop every rank: ask them to leave, then end those still
        running after a few seconds (at once with ``kill``)."""
        if not kill:
            for conn in self._conns:
                try:
                    conn.send(None)
                except OSError:
                    pass
        for p in self._procs:
            p.join(0 if kill else 10)
            if p.is_alive():
                p.kill()
                p.join(5)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)
