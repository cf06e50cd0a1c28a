"""
Learning-rate schedules as closed-form functions of the step.

The port's own copy of ``cosine_annealing_with_warmup`` and
``_resolve_fraction`` from ``adell_mri_tpu/train/schedules.py``
(the reference's CosineAnnealingWithWarmupLR).
"""

import math


def _resolve_fraction(value, t_max):
    """Values in (0, 1] are fractions of t_max."""
    if value is None:
        return 0
    if isinstance(value, float) and 0 < value <= 1:
        return value * t_max
    return value


def cosine_annealing_with_warmup(
    base_lr: float,
    t_max: int,
    n_warmup_steps=0,
    eta_min: float = 0.0,
    start_decay=None,
):
    """Linear warmup from eta_min to base_lr over n_warmup_steps, hold
    until start_decay, cosine decay to eta_min at t_max. Returns
    ``step -> lr``."""
    if start_decay is None:
        start_decay = n_warmup_steps
    n_warmup_steps = _resolve_fraction(n_warmup_steps, t_max)
    start_decay = _resolve_fraction(start_decay, t_max)
    # decay starts at max(warmup, start_decay), the reference's closed form
    decay_from = max(n_warmup_steps, start_decay)

    def schedule(step) -> float:
        step = float(step)
        if step < n_warmup_steps:
            warm = eta_min + (base_lr - eta_min) * (step + 1) / max(
                1.0, n_warmup_steps
            )
            return min(warm, base_lr)
        decay_span = max(1.0, t_max - decay_from)
        progress = min(max((step - decay_from) / decay_span, 0.0), 1.0)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * progress)
        )

    return schedule
