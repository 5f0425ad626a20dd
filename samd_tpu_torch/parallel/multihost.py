"""Multi-process helpers: process-group set-up and request sharding
(counterpart of ``samd_tpu/parallel/multihost.py``).

Processes run the same program under ``torch.distributed``; model shards
span them through a ``sharding.Mesh`` over the whole world, while
*requests* are sharded across data-parallel process groups: each serves
its own slice of the workload and only token ids cross process
boundaries.  Nothing on a machine announces a cluster: the caller names
the coordinator's address, the world size and its rank.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, TypeVar, Union

import torch
import torch.distributed as dist

from .sharding import Mesh, make_mesh

T = TypeVar("T")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None) -> None:
    """Join the process group (a no-op for one process).

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of rank
    0.  ``backend=None`` means NCCL, one rank per CUDA device of this host
    (``LOCAL_WORLD_SIZE`` ranks, else ``num_processes``): it raises when
    two ranks would share a device, and sets this rank's device
    (``LOCAL_RANK``, else ``process_id``).  Any other backend, such as
    "gloo" for ranks on the CPU or ranks sharing one card, is used as
    named."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("more than one process needs the coordinator's "
                         "address and this process's id")
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("backend=None means NCCL, and no CUDA device "
                               "is available; name a backend such as "
                               "'gloo'")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        count = torch.cuda.device_count()
        if local_world > count:
            raise RuntimeError(
                f"{local_world} ranks on this host would share its {count} "
                "CUDA device(s), which NCCL refuses; name backend='gloo'")
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % count)
        backend = "nccl"
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def global_mesh(dp: int = 1, *,
                device: Union[str, torch.device] = "cuda") -> Mesh:
    """Mesh over every rank of every process, ``dp`` data-parallel groups
    of ``world / dp`` tensor-parallel ranks (axes "pp" and "ep" of size
    1); keep "tp" within a host (dp = number of hosts for
    host-data-parallel serving)."""
    n = dist.get_world_size()
    if n % dp:
        raise ValueError(f"{n} devices not divisible by dp={dp}")
    return make_mesh(dp=dp, device=device)


def shard_requests(items: Sequence[T], *, process_id: Optional[int] = None,
                   num_processes: Optional[int] = None) -> List[T]:
    """Static round-robin split of a request list across processes: this
    process's share, by default by its rank in the world (the whole list
    when no process group is up)."""
    up = dist.is_initialized()
    pid = process_id if process_id is not None else (
        dist.get_rank() if up else 0)
    n = num_processes if num_processes is not None else (
        dist.get_world_size() if up else 1)
    return [x for i, x in enumerate(items) if i % n == pid]
