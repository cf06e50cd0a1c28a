"""
Train state.

Counterpart of ``TrainState`` in ``adell_mri_tpu/train/state.py``: the
step count, the f32 master parameters (the model's own ``nn.Parameter``s,
by name), the optimizer, the batch norms' running statistics
(``variables``, the JAX state's ``batch_stats`` collection: empty for a
model without batch norm) and, optionally, a shadow of the parameters
(``ema_params``) updated after every optimizer step: their stochastic
weight average (``swa_start_step``: an equal-weight running mean from
that step on) or their exponential moving average (``with_ema``: the
self-supervised teachers; decay ``ema_decay_at`` of the step count before
the step's increment, ``ema_decay`` ramped to ``ema_final_decay`` over
``ema_n_steps``, as the JAX state's "ema" mode). As in the JAX package
the shadow covers the parameters only; the statistics are the latest
step's. ``constants`` are the model's other persistent buffers (a GP
head's random features): outside a step's weights, in ``state_dict``.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from adell_mri_torch.models.layers.adn import batch_stats
from adell_mri_torch.train.ema import ema_decay_at, ema_update, swa_decay_at
from adell_mri_torch.train.optim import Optimizer


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    tx: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    swa_start_step: int = 0
    variables: Dict[str, torch.Tensor] = field(default_factory=dict)
    ema_mode: str = "swa"
    ema_decay: float = 0.99
    ema_final_decay: Optional[float] = None
    ema_n_steps: Optional[int] = None
    # the model's other persistent buffers (a GP head's random features):
    # fixed, outside a step's weights, kept in the checkpoints
    constants: Dict[str, torch.Tensor] = field(default_factory=dict)

    @classmethod
    def create(cls, model, tx_factory,
               swa_start_step: Optional[int] = None,
               with_ema: bool = False, ema_decay: float = 0.99,
               ema_final_decay: Optional[float] = None,
               ema_n_steps: Optional[int] = None) -> "TrainState":
        """``tx_factory(params) -> Optimizer`` over the model's
        parameters; with ``swa_start_step`` a shadow copy of them keeps
        their stochastic weight average from that step on, with
        ``with_ema`` their exponential moving average. The running
        statistics start as the model's own."""
        if with_ema and swa_start_step is not None:
            raise ValueError("a state keeps one shadow: SWA or EMA")
        params = dict(model.named_parameters())
        variables = (batch_stats(model) if isinstance(model, torch.nn.Module)
                     else {})
        constants = {k: v for k, v in model.state_dict().items()
                     if k not in params and k not in variables
                     } if isinstance(model, torch.nn.Module) else {}
        state = cls(step=0, params=params, tx=tx_factory(params),
                    variables=variables, constants=constants,
                    ema_mode="ema" if with_ema else "swa",
                    ema_decay=ema_decay, ema_final_decay=ema_final_decay,
                    ema_n_steps=ema_n_steps)
        if swa_start_step is not None or with_ema:
            state.ema_params = {k: v.detach().clone()
                                for k, v in params.items()}
            state.swa_start_step = swa_start_step or 0
        return state

    def shadow_decay(self) -> float:
        """The shadow's decay at this step (before its increment)."""
        if self.ema_mode == "ema":
            return ema_decay_at(self.step, self.ema_decay,
                                self.ema_final_decay, self.ema_n_steps)
        return swa_decay_at(self.step, self.swa_start_step)

    def apply_gradients(self, grads: Dict[str, torch.Tensor],
                        variables: Optional[Dict[str, torch.Tensor]] = None
                        ) -> "TrainState":
        """Updates the parameters in place, then the shadow, takes the
        step's running statistics (``variables``, when given) and counts
        the step."""
        self.tx.step(grads, self.params)
        if self.ema_params is not None:
            ema_update(self.ema_params, self.params, self.shadow_decay())
        if variables:
            self.variables = {**self.variables, **variables}
        self.step += 1
        return self

    def weights(self, params: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """``params`` (the state's by default, or e.g. its shadow) with the
        running statistics: what a step or a forward takes."""
        return {**(self.params if params is None else params),
                **self.variables}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach()
                for k, v in {**self.weights(), **self.constants}.items()}
