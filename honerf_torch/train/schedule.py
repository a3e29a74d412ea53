"""Learning-rate schedule (counterpart of honerf_tpu.train.schedule):
linear warmup, then cosine decay to `alpha * base_lr`."""

from __future__ import annotations

import math


def warmup_cosine_factor(step: int, warm_up_end: float, end_iter: int, alpha: float) -> float:
    """Multiplicative LR factor at `step`."""
    step = float(step)
    if warm_up_end > 0 and step < warm_up_end:
        return step / max(warm_up_end, 1.0)
    progress = (step - warm_up_end) / max(end_iter - warm_up_end, 1.0)
    return (math.cos(math.pi * progress) + 1.0) * 0.5 * (1.0 - alpha) + alpha


def make_lr_schedule(learning_rate: float, warm_up_end: float, end_iter: int, alpha: float):
    """step -> learning rate."""

    def schedule(step):
        return learning_rate * warmup_cosine_factor(step, warm_up_end, end_iter, alpha)

    return schedule
