"""Process-group bring-up and device-mesh construction.

Counterpart of `youreditableavatar_tpu/parallel/mesh.py` on
`torch.distributed`: one process per card, NCCL between cards (gloo between
CPU processes), and a `DeviceMesh` whose axes name the ways the work splits.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from youreditableavatar_tpu_torch.utils.device import resolve_device

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout: Optional[timedelta] = None,
) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    The cluster is named either explicitly — `coordinator_address`
    ("host:port", or an `init_method` URL such as "file:///path"),
    `num_processes` and `process_id` — or by the torchrun variables RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT. Where nothing names one, the
    call is a no-op: one process, no group, (0, 1). The backend follows the
    device the caller names: NCCL for `cuda` (the default), gloo for `cpu`.
    A group that exists already is kept. A failed bring-up raises.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    explicit = coordinator_address is not None
    if not explicit and not all(k in os.environ for k in _TORCHRUN_VARS):
        return 0, 1
    dev = resolve_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes "
                             "and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kw.update(init_method=url, world_size=int(num_processes),
                  rank=int(process_id))
        rank = int(process_id)
    else:
        kw.update(init_method="env://")
        rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(
    axis_sizes: Sequence[int],
    axis_names: Sequence[str] = ("data", "tile"),
    device=None,
) -> DeviceMesh:
    """A `DeviceMesh` over the process group's ranks.

    `axis_sizes` may contain one −1 (inferred). The mesh spans the whole
    world (a `DeviceMesh` over part of it is not supported here) and its
    trailing axis runs over neighbouring ranks. Call `distributed_init`
    first; `device` (`cuda` unless named) must match the group's backend.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    sizes = list(axis_sizes)
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh needs {total} devices, have {n}")
    if total < n:
        raise ValueError(f"mesh of {total} ranks must span all {n}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "distributed_init first")
    dev = resolve_device(device)
    backend = dist.get_backend()
    if (dev.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"a {dev.type} mesh cannot run on the {backend} "
                         f"backend")
    return init_device_mesh(dev.type, tuple(sizes),
                            mesh_dim_names=tuple(axis_names[: len(sizes)]))
