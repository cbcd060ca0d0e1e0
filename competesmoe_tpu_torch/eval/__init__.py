"""The eval harness (port of competesmoe_tpu/eval): tasks, metrics, the
evaluation loop, the response cache and the LLaVA adapter."""

from . import metrics  # noqa: F401  (populate registries)
from .collator import Collator  # noqa: F401
from .evaluator import evaluate, make_table, simple_evaluate  # noqa: F401
from .instance import Instance  # noqa: F401
from .llava_adapter import TorchLlava, routing_telemetry  # noqa: F401
from .task import (  # noqa: F401
    TASK_REGISTRY,
    ConfigurableTask,
    TaskConfig,
    get_task_config,
    register_task,
)
from .cache import CachingLM  # noqa: F401
