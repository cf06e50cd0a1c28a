"""
Self-supervised train steps.

Counterpart of ``make_two_view_step``, ``make_ssl_train_step`` and
``make_ijepa_step`` in ``adell_mri_tpu/train/ssl_steps.py``.

The precision policy is the JAX steps' ``_downcast``/``_f32``: every
forward runs on compute-dtype copies of the weights and inputs (the
running statistics stay f32) and returns f32, so the losses and the EMA
are f32 (``steps._forward_fn``). A step is ``loss_and_metrics(params,
batch, ema_params=None)``, ``params`` being the state's weights with the
running statistics (``TrainState.weights``).

- Two-view methods (``batch["view1"]``, ``batch["view2"]``): SimSiam and
  BYOL run the student's two predictions and the teacher's two
  projections (the EMA shadow with ``ema_teacher``, else the parameters)
  and take the symmetrised loss; VICReg, Barlow Twins and SimCLR
  (``ntxent``) take the two projections (the second detached with
  ``stop_gradient``). The teacher forwards, and a detached second
  projection, run under ``torch.no_grad()``: the values JAX's
  stop-gradient gives, with no activations kept. Every forward is in
  training mode, so each batch norm normalises by its batch's
  statistics; only the statistics of the student's ``view1`` forward are
  kept (``metrics["_variables"]``), as the JAX step keeps only that
  forward's mutated collection, and the others' are dropped.
- I-JEPA (``batch["image"]``, else ``view1``): one block mask a step,
  drawn from ``generator``; with an EMA shadow the target encoder runs
  the shadow of the context encoder.

``make_ssl_train_step`` takes the gradient with respect to every
parameter: a leaf the loss does not reach (the prediction head of a
projection-only method, I-JEPA's target encoder) gets zeros, not
``None``, so AdamW decays it and moves its moments as optax does.
"""

from typing import Callable, Optional

import torch

from adell_mri_torch.models.layers.adn import batch_stats, pop_batch_stats
from adell_mri_torch.models.ssl import losses as L
from adell_mri_torch.models.ssl.masking import block_masking
from adell_mri_torch.train.steps import _detached, _forward_fn


def make_two_view_step(
    model,
    method: str = "vicreg",
    ema_teacher: bool = False,
    symmetrize: bool = True,
    loss_kwargs: Optional[dict] = None,
    stop_gradient: bool = False,
    precision: Optional[str] = None,
):
    """Returns ``loss_and_metrics(params, batch, ema_params=None)`` for
    SimSiam, BYOL, VICReg, Barlow Twins and SimCLR over batches with
    ``view1`` and ``view2``. Metrics: ``loss`` (VICReg: its
    ``invariance``, ``variance`` and ``covariance`` too) and the kept
    running statistics in ``_variables``."""
    loss_kwargs = loss_kwargs or {}
    forward = _forward_fn(model, precision)
    stat_names = set(batch_stats(model))

    def run(weights, x, ret, keep=False):
        out = forward(weights, x, ret=ret)
        stats = pop_batch_stats(model)
        return out, (stats if keep else None)

    def loss_and_metrics(params, batch, ema_params=None):
        model.train(True)
        v1, v2 = batch["view1"], batch["view2"]
        teacher = params
        if ema_teacher and ema_params is not None:
            teacher = {**ema_params,
                       **{k: params[k] for k in stat_names}}
        if method in ("simsiam", "byol"):
            p1, new_vars = run(params, v1, "prediction", keep=True)
            p2, _ = run(params, v2, "prediction")
            with torch.no_grad():
                z1, _ = run(teacher, v1, "projection")
                z2, _ = run(teacher, v2, "projection")
            fn = L.simsiam_loss if method == "simsiam" else L.byol_loss
            loss = fn(p1, z2)
            if symmetrize:
                loss = 0.5 * (loss + fn(p2, z1))
            metrics = {"loss": loss}
        else:
            z1, new_vars = run(params, v1, "projection", keep=True)
            if stop_gradient:
                with torch.no_grad():
                    z2, _ = run(params, v2, "projection")
            else:
                z2, _ = run(params, v2, "projection")
            if method == "vicreg":
                loss, comp = L.vicreg_loss(z1, z2, **loss_kwargs)
                metrics = {"loss": loss, **comp}
            elif method == "barlow_twins":
                loss = L.barlow_twins_loss(z1, z2, **loss_kwargs)
                metrics = {"loss": loss}
            elif method in ("simclr", "ntxent"):
                loss = L.ntxent_loss(z1, z2, **loss_kwargs)
                metrics = {"loss": loss}
            else:
                raise NotImplementedError(f"ssl method {method!r}")
        if new_vars:
            metrics["_variables"] = new_vars
        return loss, metrics

    return loss_and_metrics


def make_ijepa_step(model, precision: Optional[str] = None,
                    generator: Optional[torch.Generator] = None):
    """Returns ``loss_and_metrics(params, batch, ema_params=None)``: the
    I-JEPA loss at the masked positions, the mask drawn from
    ``generator`` (or ``batch["mask"]``, a [N] mask, where given). With
    ``ema_params`` holding the context encoder's shadow, the target
    encoder's weights are that shadow."""
    forward = _forward_fn(model, precision)
    stem = "target_encoder."

    def loss_and_metrics(params, batch, ema_params=None):
        model.train(True)
        x = batch["image"] if "image" in batch else batch["view1"]
        weights = dict(params)
        if ema_params is not None and any(
                k.startswith("context_encoder.") for k in ema_params):
            for k in params:
                if k.startswith(stem):
                    weights[k] = ema_params[
                        "context_encoder." + k[len(stem):]]
        mask = batch.get("mask")
        if mask is None:
            mask = block_masking(generator, model.grid,
                                 model.n_target_blocks)
        pred_f, tgt_f, mask_b = forward(weights, x, mask=mask)
        loss = L.ijepa_loss(pred_f, tgt_f, mask=mask_b)
        return loss, {"loss": loss}

    return loss_and_metrics


def make_ssl_train_step(loss_and_metrics: Callable):
    """``train_step(state, batch) -> (state, metrics)``: the loss's value
    and gradient with respect to ``state.params`` (zeros for the leaves it
    does not reach), with the state's EMA shadow handed to the step, then
    one optimizer update, which also moves the shadow; the kept running
    statistics go into the state."""

    def train_step(state, batch):
        loss, metrics = loss_and_metrics(state.weights(), batch,
                                         ema_params=state.ema_params)
        names = list(state.params)
        grads = torch.autograd.grad(
            loss, [state.params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(state.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        state = state.apply_gradients(
            grads, variables=metrics.pop("_variables", None))
        return state, _detached(metrics)

    return train_step
