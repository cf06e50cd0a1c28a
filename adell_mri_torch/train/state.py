"""
Train state.

Counterpart of ``TrainState`` in ``adell_mri_tpu/train/state.py``: the
step count, the f32 master parameters (the model's own ``nn.Parameter``s,
by name), the optimizer and, optionally, the stochastic weight average of
the parameters (``ema_params``: an equal-weight running mean from
``swa_start_step`` on), updated after every optimizer step. The JAX
package's EMA mode is used only by ``--semi_supervised``, which is not
ported yet.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from adell_mri_torch.train.ema import ema_update, swa_decay_at
from adell_mri_torch.train.optim import Optimizer


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    tx: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    swa_start_step: int = 0

    @classmethod
    def create(cls, model, tx_factory,
               swa_start_step: Optional[int] = None) -> "TrainState":
        """``tx_factory(params) -> Optimizer`` over the model's
        parameters; with ``swa_start_step`` a shadow copy of them keeps
        their stochastic weight average from that step on."""
        params = dict(model.named_parameters())
        if swa_start_step is None:
            return cls(step=0, params=params, tx=tx_factory(params))
        ema = {k: v.detach().clone() for k, v in params.items()}
        return cls(step=0, params=params, tx=tx_factory(params),
                   ema_params=ema, swa_start_step=swa_start_step)

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
        """Updates the parameters in place, then the shadow, and counts
        the step."""
        self.tx.step(grads, self.params)
        if self.ema_params is not None:
            ema_update(self.ema_params, self.params,
                       swa_decay_at(self.step, self.swa_start_step))
        self.step += 1
        return self

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.params.items()}
