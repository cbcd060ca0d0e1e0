"""Parallelism: process groups, the data/expert/seq and data/model rank
grids, FSDP, expert parallelism, ring attention and tensor-parallel
serving (port of competesmoe_tpu/parallel/)."""

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
    decoder_param_shardings,
    ep_param_shardings,
    kv_cache_sharding,
    llava_param_shardings,
    make_mesh,
    make_param_shardings,
    make_tp_mesh,
    put_batch,
    replicated,
    shard_params,
)
from .ring_attention import (  # noqa: F401
    make_ring_attention,
    make_ring_attention_masked,
)
from .seq_context import (  # noqa: F401
    current_seq_mesh,
    set_seq_mesh,
    use_sequence_parallel,
)
