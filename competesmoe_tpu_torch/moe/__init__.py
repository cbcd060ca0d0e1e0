from . import layers  # noqa: F401  (populate the registry)
from .config import MoEArgs  # noqa: F401
from .layers import MoEAux  # noqa: F401
from .registry import MOE_REGISTRY, get_moe, register_moe  # noqa: F401
