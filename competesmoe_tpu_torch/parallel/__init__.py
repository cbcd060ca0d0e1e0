"""Parallelism: process groups, the data/expert rank grid, FSDP and
expert parallelism (port of competesmoe_tpu/parallel/, less ring
attention and the tensor-parallel half: ROADMAP item 1.7b)."""

from .distributed import (  # noqa: F401
    DistributedEnv,
    detect_env,
    initialize,
    is_restart,
    run_identifier,
)
from .ep_context import (  # noqa: F401
    current_ep_mesh,
    set_ep_mesh,
    use_expert_parallel,
)
from .expert_parallel import (  # noqa: F401
    make_ep_all_experts_kv,
    make_ep_all_experts_mlp2,
    make_ep_ffn_kv,
    make_ep_ffn_mlp2,
    make_ep_ffn_swiglu,
)
from .mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    make_param_shardings,
    put_batch,
    replicated,
    shard_params,
)
