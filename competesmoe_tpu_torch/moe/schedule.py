"""CompeteSMoE competition ("flip") schedule generation.

Reference semantics (moe_model/model/moe/competesmoe.py:90-176,
moe_pretrain_model/layers/moe/competesmoe.py:123-273):

- total training steps split into a warm-up prefix (`warm_up * total`) and
  `flip_steps = total - step_warm` schedulable steps;
- for each layer, in layer order, every step independently becomes a
  competition candidate with probability `rate_flip`;
- a per-step budget `max_compete_in_iter` caps how many *layers* may compete
  on the same step; an over-budget candidate is shifted to the nearest free
  earlier step, else the nearest free later step (a step is free for this
  layer if it is under budget and not already taken by this layer);
- layer schedules chain: layer i sees the cumulative per-step counts of
  layers 0..i-1.

The reference generates this on rank 0 with torch RNG and `dist.broadcast`s
it. Here the schedule is a pure function of (seed, layer order),
generated identically on every host with NumPy — no collective needed.
A numpy-only copy of competesmoe_tpu/moe/schedule.py: the same arguments
give the same `flips` bit for bit in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlipSchedule:
    """Per-layer competition schedule."""

    step_warm: int
    flip_steps: int
    # [n_layers, flip_steps] bool; row i is layer i's schedule
    flips: np.ndarray

    def is_flip(self, layer: int, step: int) -> bool:
        """Host-side check: does `layer` compete at global step `step`?"""
        if step < self.step_warm:
            return False
        return bool(self.flips[layer, step - self.step_warm])

    def layer_schedule(self, layer: int) -> np.ndarray:
        return self.flips[layer]

    @property
    def n_layers(self) -> int:
        return self.flips.shape[0]

    def competition_rate(self, layer: int) -> float:
        return float(self.flips[layer].mean())


def balanced_flip_row(rng: np.random.Generator, flip_steps: int,
                      rate_flip: float, max_compete_in_iter: int,
                      cum_frequency: np.ndarray) -> np.ndarray:
    """One layer's schedule given the cumulative counts of previous layers.

    Mirrors `create_balanced_flip_current` exactly: sequential candidate
    draws, budget check, shift-left then shift-right rebalancing.
    """
    candidate = np.zeros(flip_steps, dtype=bool)
    freq = cum_frequency.astype(np.int64).copy()
    draws = rng.random(flip_steps)
    for i in range(flip_steps):
        if draws[i] >= rate_flip:
            continue
        if freq[i] < max_compete_in_iter:
            candidate[i] = True
            freq[i] += 1
            continue
        # Shift left to the nearest free step.
        placed = False
        for j in range(i - 1, -1, -1):
            if freq[j] < max_compete_in_iter and not candidate[j]:
                candidate[j] = True
                freq[j] += 1
                placed = True
                break
        if not placed:
            # Then shift right.
            for j in range(i + 1, flip_steps):
                if freq[j] < max_compete_in_iter and not candidate[j]:
                    candidate[j] = True
                    freq[j] += 1
                    break
    return candidate


def build_flip_schedule(n_layers: int, total_steps: int, warm_up: float,
                        rate_flip: float, max_compete_in_iter: int,
                        seed: int = 0,
                        layer_ids: Optional[list] = None) -> FlipSchedule:
    """Build the chained multi-layer schedule deterministically from `seed`.

    Every host calls this with the same arguments and gets the same result —
    the TPU-native replacement for the reference's rank-0 generate +
    dist.broadcast (competesmoe.py:134-155).
    """
    step_warm = int(warm_up * total_steps)
    flip_steps = total_steps - step_warm
    if flip_steps <= 0:
        raise ValueError("total_steps - step_warm must be > 0 "
                         f"(total={total_steps}, warm={step_warm})")
    rng = np.random.default_rng(seed)
    flips = np.zeros((n_layers, flip_steps), dtype=bool)
    cum = np.zeros(flip_steps, dtype=np.int64)
    for layer in range(n_layers):
        row = balanced_flip_row(rng, flip_steps, rate_flip,
                                max_compete_in_iter, cum)
        flips[layer] = row
        cum += row
    return FlipSchedule(step_warm=step_warm, flip_steps=flip_steps,
                        flips=flips)


def schedule_to_dict(s: FlipSchedule) -> Dict:
    return {"step_warm": s.step_warm, "flip_steps": s.flip_steps,
            "flips": s.flips.astype(np.uint8).tolist()}


def schedule_from_dict(d: Dict) -> FlipSchedule:
    return FlipSchedule(step_warm=int(d["step_warm"]),
                        flip_steps=int(d["flip_steps"]),
                        flips=np.asarray(d["flips"], dtype=np.uint8).astype(bool))
