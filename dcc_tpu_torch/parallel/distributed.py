"""Multi-process launch layer on ``torch.distributed``.

Counterpart of :mod:`dcc_tpu.parallel.distributed`: one process (rank) per
device, joined into one process group, after which the same training
program runs on every rank with the env axis split over them
(:mod:`dcc_tpu_torch.parallel.mesh`). A single-process run joins nothing,
so the same entry point works from one device to many.

The control plane (process identity, the coordinator, the run-dir
broadcast, barriers) rides the process group's ``TCPStore``, not device
collectives: it works before any device computation and on any backend,
as the JAX package's rides its coordination service. Host-side side
effects (run dirs, ``config.json``, wandb, console logs, render) run on
the coordinator alone: gate them with :func:`is_coordinator`.

A launcher passes the group's address, size and this process's rank either
as torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``) or as arguments, which win over them.
:func:`spawn` is such a launcher for the ranks of one host.
"""

from __future__ import annotations

import datetime
import itertools
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

_store = None  # the process group's store, set by initialize
_local_rank = 0
_uniq = itertools.count()
# how long a rank waits for the others: at joining, in a collective, at a
# barrier or for a broadcast string (a peer's kernel build takes minutes)
TIMEOUT = datetime.timedelta(seconds=600)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    local_rank: Optional[int] = None,
) -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` is ``host:port`` of rank 0's store, else
    ``MASTER_ADDR:MASTER_PORT``; ``num_processes`` else ``WORLD_SIZE``;
    ``process_id`` else ``RANK``; ``local_rank`` (the rank's device index
    on its host) else ``LOCAL_RANK``, else the rank. ``backend`` is "nccl"
    (CUDA tensors, one device a rank) or "gloo" (CPU tensors, or CUDA
    tensors of ranks that share a device); by default NCCL where CUDA is
    available. Without an address and with at most one process, nothing
    is joined."""
    global _store, _local_rank
    if dist.is_initialized():
        return
    env = os.environ
    # torchrun's address goes through env://, which also joins the store
    # that torchrun's agent may already host on MASTER_PORT
    url = None if coordinator_address is None else f"tcp://{coordinator_address}"
    if url is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        url = "env://"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if url is None and num_processes in (None, 1):
        return  # single-process run: nothing to join
    if url is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator's address, the process count and "
            "this process's rank (arguments, or MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK)")
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", process_id))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    store, rank, world = next(dist.rendezvous(url, process_id, num_processes,
                                              timeout=TIMEOUT))
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    _store, _local_rank = store, local_rank


def shutdown() -> None:
    """Leave the process group (no-op when none was joined)."""
    global _store
    if dist.is_initialized():
        dist.destroy_process_group()
    _store = None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This rank's device index on its host (0 in a single process)."""
    return _local_rank if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on the process that owns host-side side effects (logs, ckpt)."""
    return process_index() == 0


def broadcast_str(s: Optional[str]) -> str:
    """The coordinator's ``s`` on every process (identity when
    single-process): the timestamped run dir, so that every rank agrees on
    the checkpoint path. A unique store key per call; the other ranks wait
    for it up to the group's timeout."""
    if process_count() == 1:
        return s or ""
    key = f"dcc/bcast/{next(_uniq)}"
    if is_coordinator():
        _store.set(key, s or "")
        return s or ""
    return _store.get(key).decode()


def barrier(name: str = "dcc_barrier") -> None:
    """Block until every process reaches this point (no-op single-process),
    on the store: the last rank to arrive releases the others. Each call
    gets a unique key, so that repeated barriers of one name never
    collide."""
    n = process_count()
    if n == 1:
        return
    key = f"dcc/{name}/{next(_uniq)}"
    if _store.add(key, 1) == n:
        _store.set(key + "/done", "1")
    _store.wait([key + "/done"])


def local_first(fn):
    """``fn()`` on each host's first rank, then, after a barrier, on the
    others (the kernel build: one ``nvcc`` a source, whose libraries the
    other ranks then load). Returns its result."""
    if local_rank() == 0:
        out = fn()
        barrier("local_first")
        return out
    barrier("local_first")
    return fn()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(index: int, nprocs: int, port: int, fn, args) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(nprocs),
                      RANK=str(index), LOCAL_RANK=str(index))
    fn(*args)


def spawn(fn, nprocs: int, args: tuple = ()) -> None:
    """Run ``fn(*args)`` in ``nprocs`` fresh processes of this host, rank i
    with torchrun's variables for rank i of ``nprocs`` on a free port;
    returns when every rank has, and raises when one fails (the others are
    then terminated). ``fn`` must be importable (it is pickled by name)."""
    import torch.multiprocessing as mp

    mp.start_processes(_spawned, args=(nprocs, free_port(), fn, args), nprocs=nprocs,
                       join=True, start_method="spawn")


__all__ = [
    "barrier",
    "broadcast_str",
    "free_port",
    "initialize",
    "is_coordinator",
    "local_first",
    "local_rank",
    "process_count",
    "process_index",
    "shutdown",
    "spawn",
]
