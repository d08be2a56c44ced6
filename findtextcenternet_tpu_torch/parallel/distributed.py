"""Process-group initialisation and per-host data sharding helpers.

The port of ``findtextcenternet_tpu/parallel/distributed.py``. JAX runs
one process per host over all its chips; the port runs one process (rank)
per device, so a "host" here is a rank: its share of a work list is the
rank's, and the rows it feeds are its own.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import collectives as coll


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return int(v)
    return None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None, always: bool = False) -> bool:
    """Initialise ``torch.distributed`` when running several processes.

    Returns False (and initialises nothing) for a single process. The
    arguments fall back to JAX's ``JAX_COORDINATOR`` / ``JAX_NUM_PROCESSES``
    / ``JAX_PROCESS_ID``, then to torchrun's ``MASTER_ADDR:MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``. ``coordinator`` is ``host:port`` (or an
    ``init_method`` URL: ``tcp://...``, ``file://...``). The backend is
    NCCL on the card (``device`` None or CUDA; each rank takes the card
    ``LOCAL_RANK``, else its rank modulo the cards present) and gloo on the
    CPU (``device="cpu"``). ``always`` initialises a world of one process
    too, as a one-card check of the NCCL route."""
    from ..device import resolve_device

    if coordinator is None:
        coordinator = os.environ.get("JAX_COORDINATOR")
        if coordinator is None and os.environ.get("MASTER_ADDR"):
            coordinator = (f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes or _env_int("JAX_NUM_PROCESSES",
                                              "WORLD_SIZE") or 0
    if not coordinator or (num_processes <= 1 and not always):
        return False
    num_processes = max(1, num_processes)
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK") or 0
    dev = resolve_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else process_id % torch.cuda.device_count())
    torch.distributed.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=url,
        world_size=num_processes, rank=process_id)
    return True


def build_once(device=None) -> None:
    """Build the native libraries and, on the card, the CUDA kernels on
    each host's first rank while the other ranks wait, so that N ranks do
    not compile the same sources at once (the builds are cached, so the
    others then load them). A no-op in one process."""
    from ..device import resolve_device

    if coll.world_size() == 1:
        return
    local = _env_int("LOCAL_RANK")
    if (coll.world_rank() if local is None else local) == 0:
        from ..infer import native
        for name in ("lineengine", "hostops", "augment"):
            native.build(name)
        if resolve_device(device).type == "cuda":
            from ..ops import kernels
            kernels.build()
    coll.barrier()


def host_shard_range(total: int) -> range:
    """This rank's contiguous shard of a global work list."""
    n, i = coll.world_size(), coll.world_rank()
    per = (total + n - 1) // n
    return range(i * per, min(total, (i + 1) * per))


def global_batch_from_host(batch: dict, mesh, device=None) -> dict:
    """This rank's part of the global batch from its local rows.

    JAX builds one logically global array from every host's slice
    (``make_array_from_process_local_data``). The port keeps local tensors,
    so the global batch is, on each rank, its own rows: this returns them as
    tensors on ``device`` (the card unless the caller asks for the CPU).
    ``mesh`` is accepted for the JAX signature."""
    from ..device import resolve_device

    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}
