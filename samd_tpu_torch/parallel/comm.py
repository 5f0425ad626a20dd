"""The port's collectives, in one place.

The reference compiles its sharded steps under GSPMD, which inserts the
psums and all-gathers; the port calls these instead.  Each works over one
mesh axis as this rank sees it (``Axis``: the process group of the ranks
that differ from this one along that axis alone):

  * ``sum_`` and ``max_``: all-reduces, in place;
  * ``gather``: the axis's shards concatenated along one dimension, written
    as a sum all-reduce of a buffer that holds this rank's shard in its
    slot and -0.0 everywhere else;
  * ``broadcast``: one index's tensor to the whole axis (the pipeline's
    hand-off from stage to stage).

Everything is written on ``all_reduce`` and ``broadcast``: gloo carries
CUDA tensors through those two only, so the same code runs over NCCL and
over gloo, on either device.  A sum in which one rank adds its value to
-0.0 from every other is exact (x + -0.0 == x for every x, signed zeros
included), so a gather, and the vocabulary-sharded embedding lookup built
the same way, moves bits unchanged.  An axis of one rank has no group, and
every collective over it returns its input untouched, as GSPMD inserts no
collective over an axis of size 1.

A mesh's ``CommStats`` (``Mesh.stats``, shared by its axes) counts the
calls that reach a process group; with ``timed`` set, each such call
synchronizes the device before and after and adds its host seconds (the
collectives' share of a step, ``chip_smoke.py`` phase 19).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclass
class CommStats:
    """The collectives a mesh ran: ``calls``, and with ``timed`` set the
    host ``seconds`` they took, each synchronized on both sides."""

    calls: int = 0
    seconds: float = 0.0
    timed: bool = False


@dataclass
class Axis:
    """One mesh axis seen from this rank: its size, this rank's index
    along it, the global ranks of its slice, their process group (None for
    a slice of one rank) and the mesh's ``CommStats``."""

    name: str
    size: int
    index: int
    ranks: List[int] = field(default_factory=list)
    group: Optional[object] = None
    stats: CommStats = field(default_factory=CommStats)


def _run(op, x: torch.Tensor, stats: CommStats) -> torch.Tensor:
    stats.calls += 1
    if not stats.timed:
        op()
        return x
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    op()
    sync()
    stats.seconds += time.perf_counter() - t0
    return x


def sum_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum all-reduce of ``x`` over ``axis``, in place."""
    if axis.size == 1:
        return x
    return _run(lambda: dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                        group=axis.group), x, axis.stats)


def max_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Max all-reduce of ``x`` over ``axis``, in place."""
    if axis.size == 1:
        return x
    return _run(lambda: dist.all_reduce(x, op=dist.ReduceOp.MAX,
                                        group=axis.group), x, axis.stats)


def gather(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """The shards of ``axis`` concatenated along ``dim``, in index order,
    bit for bit (a zero-padded sum: see the module docstring)."""
    if axis.size == 1:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * axis.size
    buf = torch.full(shape, -0.0, dtype=x.dtype, device=x.device)
    buf.narrow(dim, axis.index * n, n).copy_(x)
    return sum_(buf, axis)


def broadcast(x: torch.Tensor, axis: Axis, src_index: int) -> torch.Tensor:
    """``x`` of the rank at ``src_index`` along ``axis`` into every rank's
    ``x``, in place."""
    if axis.size == 1:
        return x
    src = axis.ranks[src_index]
    return _run(lambda: dist.broadcast(x, src=src, group=axis.group), x,
                axis.stats)
