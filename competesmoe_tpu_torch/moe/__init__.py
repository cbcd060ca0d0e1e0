from . import layers, pretrain_layers  # noqa: F401  (populate the registries)
from .config import MoEArgs  # noqa: F401
from .layers import MoEAux  # noqa: F401
from .registry import (MOE_REGISTRY, PRETRAIN_MOE_REGISTRY,  # noqa: F401
                       get_moe, get_pretrain_moe, register_moe,
                       register_pretrain_moe)
from .schedule import (FlipSchedule, build_flip_schedule,  # noqa: F401
                       schedule_from_dict, schedule_to_dict)
