"""Multi-process runtime initialization (port of
``cadepth_tpu.parallel.distributed``).

Each process of a data-parallel run drives one card and joins one
``torch.distributed`` process group: NCCL between cards, Gloo on the CPU.
Launch one process a card with ``torchrun``, which sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``::

    torchrun --nproc-per-node 4 -m cadepth_tpu_torch.cli.train \
        --config configs/train_config.yaml --multihost

or start each process yourself with JAX's names for the same settings:
``COORDINATOR_ADDRESS`` (host:port), ``NUM_PROCESSES`` and ``PROCESS_ID``.
Nothing on a machine announces a cluster: the coordinator is always
given.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("cadepth_tpu_torch")


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group (idempotent); run it before anything else
    touches a card.

    The arguments default to ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and
    ``PROCESS_ID``, then to torchrun's ``MASTER_ADDR``:``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. ``backend`` defaults to NCCL where a card
    is visible and Gloo elsewhere; under NCCL the process takes card
    ``LOCAL_RANK`` (else ``process_id`` modulo the visible cards).

    Returns True once the group is joined (or was already), False when no
    coordinator is configured: the run is then one process.

    Unlike JAX's, a configured coordinator that cannot be joined raises.
    JAX's catches every exception and runs on as a single process, so a
    misconfigured multi-process launch would train one unsynchronized
    copy a process without a word.
    """
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if not coordinator_address and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '')}")
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    if not coordinator_address:
        log.info("no coordinator configured; running single-process")
        return False

    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {coordinator_address!r} is "
                         "not host:port")
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator needs the process count and this process's id "
            "(num_processes/process_id, NUM_PROCESSES/PROCESS_ID or "
            "WORLD_SIZE/RANK)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside "
                         f"0..{num_processes - 1}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        # c10d's flight recorder (a ring of the last collectives, with
        # stack traces, for dumps after a hang) made an all-reduce's host
        # time 116 us instead of 23 after 40 flagship steps on an H100:
        # off unless the caller sets its buffer size
        for name in ("TORCH_NCCL_TRACE_BUFFER_SIZE", "TORCH_FR_BUFFER_SIZE"):
            os.environ.setdefault(name, "0")
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(process_id % torch.cuda.device_count()
                              if local is None else local)
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            world_size=num_processes, rank=process_id)
    log.info("distributed runtime: process %d/%d over %s", process_id,
             num_processes, backend)
    return True
