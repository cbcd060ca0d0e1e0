"""MoE hyperparameter bundle.

One frozen dataclass covers both reference trees' knobs
(moe_model/train/train.py:96-145 `ModelArguments` and
moe_pretrain_model/tasks/transformer_lm_mixin.py:20-105 `@args` flags).
Frozen + hashable; a copy of competesmoe_tpu/moe/config.py.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEArgs:
    # --- shared loss coefficients ---
    balance_loss_coef: float = 0.01
    router_z_loss_coef: float = 0.001

    # --- CompeteSMoE schedule ---
    rate_flip: float = 0.05
    warm_up: float = 0.0
    max_compete_in_iter: int = 2
    schedule_seed: int = 0

    # --- CompeteSMoE losses ---
    router_loss_coef: float = 0.01
    diversity_loss_coef: float = 0.01     # multimodal tree
    bal_comp_loss_coef: float = 0.01      # multimodal tree (balance on affinity)
    balance_loss_coef_comp: float = 0.01  # pretrain tree
    balance_affinity: bool = False        # pretrain tree
    router_theta: float = 1.0

    # --- router-loss variants ---
    hybrid: bool = False
    tribrid: bool = False
    in_topk: bool = False

    # --- gating variants ---
    is_cosine: bool = False
    is_norm_weight: bool = False
    norm_sigmoid: bool = False
    norm_softmax: bool = False
    scale_weight: float = 1.0

    # --- XMoE ---
    xmoe_temperature: float = 0.3
    xmoe_theta: float = 0.1  # perturbed-cosine denominator offset

    # --- misc ---
    init_weight: bool = True
    gate_init_std: float = 0.02
    test_only: bool = False

    def validate(self):
        if self.is_cosine and self.is_norm_weight:
            raise ValueError(
                "Cannot activate both is_cosine and is_norm_weight; pick one "
                "normalization (ref layers/moe/competesmoe.py:477)")
        return self
