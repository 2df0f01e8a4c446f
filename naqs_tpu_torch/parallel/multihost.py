"""Process-group set-up for data-parallel VMC over `torch.distributed`.

Port of `naqs_tpu/parallel/multihost.py`. One process runs each rank; the
sharded steps (`parallel/step.py`) need nothing else of the launch: the
parameters are replicated, and the only traffic is the gather of the
sampled psi table and the sums of scalars and gradients (`parallel/comm.py`).

Usage in each process of a multi-process run (under `torchrun`, whose
environment carries MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK):

    from naqs_tpu_torch.parallel import initialize_distributed
    initialize_distributed()                       # env://
    trainer = VMCTrainer(..., n_devices=dist.get_world_size())

or with the rendezvous given: `initialize_distributed("file:///tmp/run/store",
2, rank)`, or a "host:port" (tcp) address.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from naqs_tpu_torch.utils.device import resolve_device

ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
TIMEOUT = datetime.timedelta(minutes=10)   # a collective that waits longer raises


def backend_for(device) -> str:
    """The process group's backend for a device: NCCL for a CUDA device, gloo
    for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> bool:
    """Set up the default process group; a no-op that returns False for a
    single process.

    With no argument it reads the `env://` rendezvous of `torchrun`
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); with none of those either
    it does nothing and returns False. `coordinator_address` is an
    init_method URL (`file://...`, `tcp://...`) or a "host:port". It returns
    True once the group is up, also when it already was. The backend is
    `backend_for(device)` unless `backend` names one (gloo for ranks that
    share one card): the device is the CUDA card unless the caller passes
    another. A failure re-raises when more than one process was asked for,
    by the arguments or by WORLD_SIZE; otherwise it returns False."""
    explicit = ((num_processes is not None and num_processes > 1)
                or (num_processes is None and int(os.environ.get("WORLD_SIZE", "1")) > 1))
    if dist.is_initialized():
        return True
    given = coordinator_address is not None or num_processes is not None
    if not given and not all(k in os.environ for k in ENV_KEYS):
        return False
    if (num_processes is not None and num_processes > 1
            and not 0 <= (process_id if process_id is not None else -1) < num_processes):
        raise ValueError(f"process_id {process_id} is not a rank of {num_processes} processes")
    backend = backend or backend_for(resolve_device(device))
    try:
        dist.init_process_group(
            backend=backend,
            init_method=_init_method(coordinator_address) if coordinator_address else "env://",
            world_size=num_processes if num_processes is not None else -1,
            rank=process_id if process_id is not None else -1,
            timeout=TIMEOUT)
        return True
    except (ValueError, RuntimeError):
        if explicit:
            raise
        return False


def rank_device(device=None) -> torch.device:
    """The device of this process's rank: `device` where the caller passes one
    (the CPU in tests; one card that several ranks share), else the card
    cuda:LOCAL_RANK (`torchrun` and `launch.spawn` set LOCAL_RANK), else
    cuda:rank. Without LOCAL_RANK, a group of more ranks than the cards seen
    raises: two ranks would share a card, which NCCL refuses."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)   # raises without a card
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local))
    world, count = dist.get_world_size(), torch.cuda.device_count()
    if world > count:
        raise RuntimeError(f"a group of {world} ranks on {count} CUDA card(s) and no LOCAL_RANK: "
                           f"pass each rank its device")
    return torch.device("cuda", dist.get_rank())


def rank_generator(seed: int, rank: int, device=None) -> torch.Generator:
    """One explicit generator per rank (`device_key_shard`'s counterpart): its
    seed is drawn from (seed, rank) by numpy's SeedSequence, so the ranks'
    streams differ and each is the same in every run."""
    state = np.random.SeedSequence([int(seed), int(rank)]).generate_state(2, np.uint32)
    s = (int(state[0]) << 31) ^ int(state[1])
    return torch.Generator(device=resolve_device(device)).manual_seed(s)
