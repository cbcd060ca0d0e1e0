"""Multi-process runtime (port of competesmoe_tpu/parallel/distributed.py;
the reference's moe_pretrain_model/framework/helpers/distributed.py
SLURMEnv/LocalEnv and its process groups).

`detect_env` reads the process's place from the scheduler's environment:
SLURM variables first, then torchrun-style ones (`python -m
torch.distributed.run` sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), then a single process. `initialize` creates the
`torch.distributed` process group from it. The transport is chosen, never
fallen back to:

- NCCL when the ranks run on CUDA and every rank of a host has a card of
  its own;
- gloo when they run on the CPU, or share a card (NCCL refuses two ranks
  on one device). Gloo moves CUDA tensors through host memory;
- a failed NCCL initialisation raises.

`run_identifier` and `is_restart` key the preemption job record
(`train/lm_task.py`, the reference's training_helper.py:159-182).
`cli/eval_mm` splits its documents by the rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import torch


@dataclasses.dataclass
class DistributedEnv:
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    coordinator: Optional[str] = None
    is_slurm: bool = False
    is_preemptible: bool = False
    restart_count: int = 0

    @property
    def is_distributed(self) -> bool:
        return self.world_size > 1

    @property
    def is_master(self) -> bool:
        return self.rank == 0


def detect_env() -> DistributedEnv:
    env = os.environ
    if "SLURM_PROCID" in env:
        nodelist = env.get("SLURM_JOB_NODELIST", "localhost")
        head = nodelist.split(",")[0].replace("[", "").split("-")[0]
        return DistributedEnv(
            rank=int(env["SLURM_PROCID"]),
            world_size=int(env.get("SLURM_NTASKS", 1)),
            local_rank=int(env.get("SLURM_LOCALID", 0)),
            coordinator=f"{head}:{env.get('MASTER_PORT', '12355')}",
            is_slurm=True,
            is_preemptible="SLURM_RESTART_COUNT" in env,
            restart_count=int(env.get("SLURM_RESTART_COUNT", 0)))
    if "RANK" in env and "WORLD_SIZE" in env:
        return DistributedEnv(
            rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
            local_rank=int(env.get("LOCAL_RANK", 0)),
            coordinator=f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                        f"{env.get('MASTER_PORT', '12355')}")
    return DistributedEnv()


def ranks_per_card(denv: DistributedEnv) -> float:
    """How many ranks of this host share each of its cards (0 when it has
    none). The ranks of a host: LOCAL_WORLD_SIZE (torchrun), else
    SLURM_NTASKS_PER_NODE, else the whole world (one host)."""
    env = os.environ
    n_local = int(env.get("LOCAL_WORLD_SIZE")
                  or env.get("SLURM_NTASKS_PER_NODE", "").split("(")[0]
                  or denv.world_size)
    cards = torch.cuda.device_count()
    return n_local / cards if cards else 0.0


def choose_backend(denv: DistributedEnv,
                   device: Union[str, torch.device]) -> Tuple[str, str]:
    """(backend, why): NCCL when the ranks run on CUDA and each has a card
    of its own, else gloo."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", f"ranks run on {device.type}"
    share = ranks_per_card(denv)
    if share > 1:
        return "gloo", (f"{share:g} ranks share each card (NCCL refuses "
                        f"two ranks on one device; gloo stages CUDA "
                        f"tensors through host memory)")
    return "nccl", "every rank has a card of its own"


def rank_device(denv: DistributedEnv,
                device: Union[str, torch.device]) -> torch.device:
    """This rank's device: its local card (local_rank modulo the cards of
    the host, so ranks that share cards spread over them), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", denv.local_rank % torch.cuda.device_count())


def initialize(denv: Optional[DistributedEnv] = None,
               device: Union[str, torch.device, None] = None,
               init_method: Optional[str] = None,
               backend: Optional[str] = None) -> DistributedEnv:
    """Create the process group of a multi-process run (nothing for one
    process, unless `backend` is given). `init_method`: a `file://` or
    `tcp://` URL; by default `tcp://` at the scheduler's coordinator.
    `backend`: None chooses by `choose_backend`; naming one forces it
    (a failed NCCL initialisation raises either way). Prints the backend
    and why. Idempotent once the group exists."""
    import torch.distributed as dist
    denv = denv or detect_env()
    if dist.is_initialized():
        return denv
    if not denv.is_distributed and backend is None:
        return denv
    dev = torch.device("cuda" if device is None else device)
    why = "asked for"
    if backend is None:
        backend, why = choose_backend(denv, dev)
    if init_method is None:
        init_method = f"tcp://{denv.coordinator or '127.0.0.1:12355'}"
    if backend == "nccl":
        torch.cuda.set_device(rank_device(denv, dev))
    dist.init_process_group(backend, init_method=init_method,
                            rank=denv.rank, world_size=denv.world_size)
    if denv.is_master:
        print(f"distributed: {denv.world_size} ranks over {backend} "
              f"({why})", flush=True)
    return denv


def run_identifier(denv: Optional[DistributedEnv] = None) -> str:
    """Stable id of this scheduler job (the reference's
    dist_env.get_run_identifier(), keying the job records of preemption
    auto-resume, training_helper.py:159-182)."""
    env = os.environ
    if "SLURM_JOB_ID" in env:
        return f"slurm-{env['SLURM_JOB_ID']}"
    if "JOB_ID" in env:
        return f"job-{env['JOB_ID']}"
    return "local"


def is_restart(denv: Optional[DistributedEnv] = None) -> bool:
    denv = denv or detect_env()
    return denv.restart_count > 0
