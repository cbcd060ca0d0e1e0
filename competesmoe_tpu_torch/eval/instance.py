"""Evaluation request Instance.

Re-design of `evaluate/lmms_eval/api/instance.py:5-33` — including the
CompeteSMoE fork's extension: per-request routing-telemetry slots
(`logs_metrics_vision` / `logs_metrics_mlp`).

The port's own copy of competesmoe_tpu/eval/instance.py: it imports
neither JAX nor that package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class Instance:
    request_type: str               # 'loglikelihood' | 'generate_until'
    arguments: Tuple                # task-specific argument tuple
    idx: int
    metadata: Tuple[Optional[str], Optional[int], Optional[int]] = (
        None, None, None)           # (task_name, doc_id, repeats)
    resps: list = dataclasses.field(default_factory=list)
    filtered_resps: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # CompeteSMoE fork extension: routing telemetry captured per request
    logs_metrics_vision: Optional[Dict[str, Any]] = None
    logs_metrics_mlp: Optional[Dict[str, Any]] = None
    # pseudobatch-padding marker: duplicated request added so uneven ranks
    # run the same number of batches; excluded from scoring
    # (evaluator.py:276-296)
    padded: bool = False

    @property
    def task_name(self):
        return self.metadata[0]

    @property
    def doc_id(self):
        return self.metadata[1]
