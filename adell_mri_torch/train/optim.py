"""
Optimizer factory.

Counterpart of ``get_optimizer`` in ``adell_mri_tpu/train/optim.py`` for
``sgd`` (Nesterov, momentum 0.99: the segmentation default), ``adam`` and
``adamw``, on ``torch.optim``. Weight decay is coupled L2 (added to the
gradient) for sgd and adam, as optax chains ``add_decayed_weights`` and
torch applies ``weight_decay``; adamw decays decoupled. ``clip_norm``
rescales the gradients by their global norm first, as
``optax.clip_by_global_norm``. The learning rate is a number or a
``step -> lr`` schedule, read once per step.

``exclude_norms_from_decay`` (the self-supervised trainers') decays only
the leaves ``wd_mask`` marks, the JAX package's rule on the JAX tree's
names (no leaf whose path holds ``bias``, ``scale``, ``norm``,
``embedding_cls`` or ``pos_embed``): the optimizer then holds two
parameter groups, the decayed leaves and the others at weight decay 0.
"""

from typing import Callable, Dict, Optional, Union

import torch
import torch.nn as nn

Schedule = Union[float, Callable]


class Optimizer:
    """A ``torch.optim`` optimizer with a per-step schedule and optional
    global-norm clipping; ``step(grads)`` applies one update."""

    def __init__(self, opt, learning_rate: Schedule, clip_norm=None):
        self.opt = opt
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm
        self.count = 0

    def lr(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)

    def step(self, grads: Dict[str, torch.Tensor], params):
        """``grads`` and ``params`` are dicts with the same keys."""
        gs = [grads[k] for k in params]
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float()) for g in gs])
            )
            scale = torch.where(
                norm > self.clip_norm, self.clip_norm / norm, 1.0
            )
            gs = [g * scale.to(g.dtype) for g in gs]
        for p, g in zip(params.values(), gs):
            p.grad = g
        lr = self.lr(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        for p in params.values():
            p.grad = None
        self.count += 1


_NO_DECAY_TOKENS = ("bias", "scale", "norm", "embedding_cls", "pos_embed")


def _jax_leaf(module: nn.Module, leaf: str) -> str:
    """The JAX tree's name of ``module``'s parameter ``leaf``: a norm's
    ``weight`` is flax's ``scale``, any other ``weight`` a ``kernel``."""
    if leaf != "weight":
        return leaf
    is_norm = isinstance(module, (nn.LayerNorm, nn.GroupNorm)) or any(
        "Norm" in c.__name__ for c in type(module).__mro__)
    return "scale" if is_norm else "kernel"


def wd_mask(model: nn.Module) -> Dict[str, bool]:
    """True for the parameters (by ``named_parameters`` name) that take
    weight decay: those whose JAX tree path, lower-cased, holds none of
    ``_NO_DECAY_TOKENS``."""
    mask = {}
    for mod_name, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            path = "/".join(name.split(".")[:-1] + [_jax_leaf(module, leaf)])
            mask[name] = not any(t in path.lower() for t in _NO_DECAY_TOKENS)
    return mask


def get_optimizer(
    optimizer_str: str = "sgd",
    learning_rate: Schedule = 1e-3,
    weight_decay: float = 0.0,
    momentum: float = 0.99,
    clip_norm: Optional[float] = None,
    params=None,
    exclude_norms_from_decay: bool = False,
    model: Optional[nn.Module] = None,
) -> Optimizer:
    """``params``: dict of the f32 master parameters. With
    ``exclude_norms_from_decay`` (and a weight decay) ``model``'s
    ``wd_mask`` splits them into a decayed group and one without decay."""
    name = optimizer_str.lower()
    plist = list(params.values())
    if exclude_norms_from_decay and weight_decay:
        if model is None:
            raise ValueError("exclude_norms_from_decay needs the model")
        mask = wd_mask(model)
        plist = [
            {"params": [p for k, p in params.items() if mask[k]]},
            {"params": [p for k, p in params.items() if not mask[k]],
             "weight_decay": 0.0},
        ]
    # the first step's rate; Optimizer.step sets it anew every step
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    if name == "sgd":
        opt = torch.optim.SGD(
            plist, lr=lr0, momentum=momentum, nesterov=True,
            weight_decay=weight_decay,
        )
    elif name == "adam":
        opt = torch.optim.Adam(plist, lr=lr0, weight_decay=weight_decay)
    elif name == "adamw":
        opt = torch.optim.AdamW(plist, lr=lr0, weight_decay=weight_decay)
    else:
        raise NotImplementedError(
            f"optimizer {optimizer_str!r} is not ported yet (the port has "
            "sgd, adam, adamw)"
        )
    return Optimizer(opt, learning_rate, clip_norm)
