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

``accumulate_gradients``, ``freeze_wrap`` and ``lr_scale_by_regex`` are
the counterparts of the JAX functions of those names (``optax.MultiSteps``,
a ``multi_transform`` with ``set_to_zero`` on the frozen leaves, and one
with ``optax.scale`` on the leaves a regex names, chained after the
optimizer).
"""

import re

from typing import Callable, Dict, Optional, Union

import torch
import torch.nn as nn

from adell_mri_torch.interop.from_flax import flax_path

Schedule = Union[float, Callable]


class Optimizer:
    """A ``torch.optim`` optimizer with a per-step schedule and optional
    global-norm clipping; ``step(grads)`` applies one update.

    ``every`` > 1 (``accumulate_gradients``) accumulates: each call adds
    its gradients to a running mean (Welford's update, as
    ``optax.MultiSteps``) and every ``every``-th call applies that mean,
    so the inner optimizer, its moments and the schedule (``count``)
    advance once per ``every`` calls. ``frozen`` (``freeze_wrap``) names
    parameters that get no update at all: no gradient step, no weight
    decay and no optimizer state, as ``optax.set_to_zero`` gives them;
    the clipping norm runs over the others, as ``optax.multi_transform``
    hands the inner transform those alone."""

    def __init__(self, opt, learning_rate: Schedule, clip_norm=None):
        self.opt = opt
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm
        self.count = 0
        self.every = 1
        self.mini_step = 0
        self.acc_grads: Optional[Dict[str, torch.Tensor]] = None
        self.frozen: frozenset = frozenset()

    def lr(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)

    def _accumulate(self, grads: Dict[str, torch.Tensor]):
        """The mean to apply, or None while the micro-steps go on."""
        if self.acc_grads is None:
            self.acc_grads = {k: torch.zeros_like(g)
                              for k, g in grads.items()}
        n = self.mini_step
        for k, g in grads.items():
            acc = self.acc_grads[k]
            acc.add_((g - acc) / (n + 1))
        self.mini_step = (n + 1) % self.every
        if self.mini_step:
            return None
        mean = self.acc_grads
        self.acc_grads = None
        return mean

    def step(self, grads: Dict[str, torch.Tensor], params):
        """``grads`` and ``params`` are dicts with the same keys."""
        if self.every > 1:
            grads = self._accumulate(grads)
            if grads is None:
                return
        names = [k for k in params if k not in self.frozen]
        gs = [grads[k] for k in names]
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float()) for g in gs])
            )
            scale = torch.where(
                norm > self.clip_norm, self.clip_norm / norm, 1.0
            )
            gs = [g * scale.to(g.dtype) for g in gs]
        # a parameter without a gradient is left alone by torch.optim
        for k, g in zip(names, gs):
            params[k].grad = g
        lr = self.lr(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        self.opt.step()
        for p in params.values():
            p.grad = None
        self.count += 1

    def accumulator_state(self) -> Dict:
        """What resuming needs of the accumulation: the micro-step and the
        running mean."""
        return {"mini_step": self.mini_step,
                "acc_grads": None if self.acc_grads is None else {
                    k: v.detach().cpu() for k, v in self.acc_grads.items()}}

    def load_accumulator_state(self, state: Dict, device=None):
        self.mini_step = int(state["mini_step"])
        acc = state["acc_grads"]
        self.acc_grads = None if acc is None else {
            k: v.to(device) for k, v in acc.items()}


def accumulate_gradients(tx: Optimizer, every: int) -> Optimizer:
    """``tx`` applying the mean of ``every`` calls' gradients once every
    ``every`` calls (``optax.MultiSteps``; no change when ``every`` <=
    1)."""
    tx.every = max(int(every or 1), 1)
    return tx


def freeze_wrap(tx: Optimizer, trainable_mask: Dict[str, bool]
                ) -> Optimizer:
    """``tx`` leaving the parameters whose mask entry is False untouched
    (``freeze_mask_by_regex``)."""
    tx.frozen = frozenset(k for k, t in trainable_mask.items() if not t)
    return tx


def lr_scale_by_regex(tx: Optimizer, params: Dict[str, torch.Tensor],
                      patterns: Dict[str, float]) -> Optimizer:
    """``tx`` with the update of each parameter whose JAX tree path
    (``flax_path``) the first matching regex of ``patterns``
    (``re.search``) names scaled by that regex's factor: its parameter
    group's rate times the factor, which scales the whole update (the
    step and the decay) of sgd, adam and adamw as ``optax.scale`` after
    the optimizer does. Call it on a fresh optimizer."""
    compiled = [(re.compile(p), float(f)) for p, f in patterns.items()]
    path_of = {id(v): flax_path(k, v) for k, v in params.items()}

    def scale(p):
        path = path_of.get(id(p), "")
        return next((f for pat, f in compiled if pat.search(path)), 1.0)

    groups = []
    for group in tx.opt.param_groups:
        by_scale: Dict[float, list] = {}
        for p in group["params"]:
            by_scale.setdefault(scale(p) * group.get("lr_scale", 1.0),
                                []).append(p)
        for factor, members in by_scale.items():
            groups.append({**group, "params": members, "lr_scale": factor})
    tx.opt.param_groups = []
    for group in groups:
        tx.opt.add_param_group(group)
    return tx


_NO_DECAY_TOKENS = ("bias", "scale", "norm", "embedding_cls", "pos_embed")


def wd_mask(model: nn.Module) -> Dict[str, bool]:
    """True for the parameters (by ``named_parameters`` name) that take
    weight decay: those whose JAX tree path (``flax_path``), lower-cased,
    holds none of ``_NO_DECAY_TOKENS``."""
    return {
        name: not any(t in flax_path(name, p).lower()
                      for t in _NO_DECAY_TOKENS)
        for name, p in model.named_parameters()
    }


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
