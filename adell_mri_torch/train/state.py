"""
Train state.

Counterpart of ``TrainState`` in ``adell_mri_tpu/train/state.py``, without
the EMA/SWA shadow: the step count, the f32 master parameters (the
model's own ``nn.Parameter``s, by name) and the optimizer.
"""

from dataclasses import dataclass
from typing import Dict

import torch

from adell_mri_torch.train.optim import Optimizer


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    tx: Optimizer

    @classmethod
    def create(cls, model, tx_factory) -> "TrainState":
        """``tx_factory(params) -> Optimizer`` over the model's
        parameters."""
        params = dict(model.named_parameters())
        return cls(step=0, params=params, tx=tx_factory(params))

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
        """Updates the parameters in place and counts the step."""
        self.tx.step(grads, self.params)
        self.step += 1
        return self

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.params.items()}
