"""
Exponential moving average of the parameters.

The port's counterpart of ``adell_mri_tpu/train/ema.py``: ``ema_decay_at``
(a decay ramped linearly to ``final_decay`` over ``n_steps`` and clamped
between the two) and ``ema_update`` (shadow <- shadow - (1 - decay) *
(shadow - params)). The decay is a Python float computed on the host from
the step count, so an update costs no host sync; the update is one
multi-tensor ``torch._foreach_lerp_`` over the shadow.
"""

from typing import Dict, Optional

import torch


def ema_decay_at(
    step: int,
    decay: float,
    final_decay: Optional[float] = None,
    n_steps: Optional[int] = None,
) -> float:
    """The decay at ``step``: ``decay`` ramped linearly to
    ``final_decay`` over ``n_steps`` and clamped between the two."""
    if final_decay is None or n_steps is None:
        return float(decay)
    ramp = float(step) * (final_decay - decay) / n_steps + decay
    return min(max(ramp, min(decay, final_decay)), max(decay, final_decay))


def swa_decay_at(step: int, swa_start_step: int) -> float:
    """Stochastic weight averaging as an EMA: ``n / (n + 1)`` with ``n``
    the steps since ``swa_start_step``, an equal-weight running mean from
    there on; before it the shadow follows the parameters (decay 0)."""
    n = max(float(step) - swa_start_step, 0.0)
    return n / (n + 1.0)


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], decay: float):
    """One EMA step of ``shadow`` towards ``params`` (dicts with the same
    keys), in place."""
    names = list(shadow)
    torch._foreach_lerp_(
        [shadow[k] for k in names], [params[k].detach() for k in names],
        1.0 - float(decay),
    )
    return shadow
