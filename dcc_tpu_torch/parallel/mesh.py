"""The env ("data") axis over the ranks of a process group.

Counterpart of :mod:`dcc_tpu.parallel.mesh`. JAX's program shards arrays
over a ``Mesh`` and lets XLA insert the gradient ``psum``; here each rank is
one process holding one device, so a :class:`Mesh` is the group, this
rank's index in it, the group's size and the rank's device, and the
program says its collectives itself:

* :meth:`Mesh.rows` is this rank's slice of an env axis (``data_sharding``
  / ``constrain``): ranks take contiguous blocks in rank order, the first
  ``n % size`` of them one env more;
* :meth:`Mesh.broadcast_` copies the coordinator's tensors to every rank
  (``replicated``), :meth:`Mesh.replicate_` its networks and optimizers;
* :meth:`Mesh.all_sum_` sums tensors over the ranks in place (``psum``),
  and :meth:`Mesh.all_gather` stacks each rank's rows in rank order.

A 1-rank mesh is legal and runs the same program, its collectives trivial
(the JAX package runs its shard_map'd program on one device too).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..envs import get_scenario, make_vec_fns
from . import distributed


class Mesh:
    """One rank's view of the data axis: ``group`` (None: the default
    group), ``rank``, ``size`` and ``device``."""

    def __init__(self, device: torch.device, group=None):
        self.group = group
        self.device = torch.device(device)
        joined = dist.is_initialized()
        self.rank = dist.get_rank(group) if joined else 0
        self.size = dist.get_world_size(group) if joined else 1

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of an axis of ``n``."""
        base, rem = divmod(n, self.size)
        lo = self.rank * base + min(self.rank, rem)
        return slice(lo, lo + base + (self.rank < rem))

    def divides(self, n: int) -> bool:
        return n % self.size == 0

    def all_sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the ranks, in place: one collective on one
        f32 buffer of them all."""
        if not dist.is_initialized():
            return
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self.group)
        i = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[i:i + n].view(t.shape))
            i += n

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` summed over the ranks."""
        t = t.clone()
        self.all_sum_([t])
        return t

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Every rank's ``tensors`` set to the coordinator's, in place."""
        if not dist.is_initialized():
            return
        src = dist.get_global_rank(self.group, 0) if self.group else 0
        for t in tensors:
            # into a copy, then back in place: the in-place copy moves the
            # tensor's version, which the packed-parameter caches key on
            buf = t.detach().clone()
            dist.broadcast(buf, src=src, group=self.group)
            t.detach().copy_(buf)

    def replicate_(self, nets, optimizers, extra: Sequence[torch.Tensor] = ()) -> None:
        """Every rank's parameters and buffers of ``nets``, state tensors of
        ``optimizers`` (those on this rank's device type: Adam's moments)
        and ``extra`` tensors set to the coordinator's, in place."""
        tensors = [t for net in nets for t in net.state_dict().values()]
        tensors += [v for opt in optimizers for st in opt.state.values() for v in st.values()
                    if torch.is_tensor(v) and v.device.type == self.device.type]
        self.broadcast_([*tensors, *extra])

    def all_gather(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's rows ``x`` (its :meth:`rows` of ``n``) and the other
        ranks', stacked in rank order: the (n, ...) tensor. Exact: an
        all-reduce of zero-padded blocks (gloo gathers no CUDA tensors), in
        the tensor's own float dtype, integers and booleans in f64."""
        if self.size == 1:
            return x
        dtype = x.dtype if x.is_floating_point() else torch.float64
        full = torch.zeros((n, *x.shape[1:]), dtype=dtype, device=x.device)
        full[self.rows(n)] = x.to(dtype)
        dist.all_reduce(full, group=self.group)
        return full.to(x.dtype)


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of the joined process group (of one rank when none was
    joined) on ``device``, by default this rank's CUDA device
    (``cuda:LOCAL_RANK``)."""
    if device is None:
        device = torch.device("cuda", distributed.local_rank())
    return Mesh(device, group)


def take_rows(state, rows: slice):
    """The rows ``rows`` of every tensor field of an env state (a dataclass
    with a leading env axis on every field)."""
    return type(state)(**{f.name: getattr(state, f.name)[rows]
                          for f in dataclasses.fields(state)})


def sharded_reset(reset_fn, mesh: Mesh, n: int):
    """``reset_fn`` for this rank's rows of ``n`` envs: a random reset draws
    all ``n`` envs' layouts from the one generator every rank holds and
    keeps this rank's, so that the ranks together reset as one process
    does; a deterministic one resets the rank's envs alone."""
    rows = mesh.rows(n)

    def reset(cfg, n_local, dtype=torch.float32, device=None, generator=None):
        if generator is None:
            return reset_fn(cfg, n_local, dtype=dtype, device=device)
        return take_rows(reset_fn(cfg, n, dtype=dtype, device=device, generator=generator),
                         rows)

    return reset


def env_fns(scenario: str, mesh: Optional[Mesh], n: int):
    """(reset_batch, step_batch) of ``scenario`` (``envs.make_vec_fns``)
    for this rank's block of ``n`` envs, its resets through
    :func:`sharded_reset`; for all of them without a mesh."""
    if mesh is None:
        return make_vec_fns(scenario)
    return make_vec_fns(scenario, sharded_reset(get_scenario(scenario)["reset"], mesh, n))
