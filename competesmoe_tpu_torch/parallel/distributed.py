"""The process's place in a multi-process run, read from the scheduler's
environment (port of `DistributedEnv` and `detect_env` in
competesmoe_tpu/parallel/distributed.py; the reference's
moe_pretrain_model/framework/helpers/distributed.py SLURMEnv/LocalEnv).

SLURM variables first, then torchrun-style ones, then a single process.
`cli/eval_mm` splits its documents by this rank; the process groups of
the rest of that module wait for ROADMAP §1 item 1.7.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


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
