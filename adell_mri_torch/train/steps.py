"""
Train and eval steps of the segmentation trainer.

Counterpart of ``make_segmentation_step``, ``make_train_step`` and
``make_eval_step`` in ``adell_mri_tpu/train/steps.py``, for the flagship
options: no deep supervision, no bottleneck classification, no
conditioning; and the sliding-window validation step of the JAX
segmentation trainer (``--sliding_window_val``). A step runs the model as
a function of its parameters (``torch.func.functional_call``) under the
mixed-precision policy, so the f32 master parameters receive the
gradients. ``train`` puts the model in training or eval mode for the call
(dropout; a model's ``Dropout`` layers draw from the generator
``models/layers/dropout.py:seed_dropout`` gave them).
"""

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from adell_mri_torch.inference.sliding_window import sliding_window_inference
from adell_mri_torch.models.segmentation.losses import CompoundLoss
from adell_mri_torch.train.precision import (
    cast_floats,
    compute_dtype,
    wrap_apply,
)


def make_segmentation_step(
    model,
    loss_fn: CompoundLoss,
    deep_supervision: bool = False,
    bottleneck_classification: bool = False,
    n_classes: int = 2,
    train: bool = True,
    precision: Optional[str] = None,
):
    """Returns ``loss_and_metrics(params, batch) -> (loss, metrics)``.
    Batch keys: ``image`` [B, *S, C], ``label`` [B, *S] (or [B, *S, 1]).
    Metrics: ``loss``, the soft ``dice`` and ``loss_{name}`` per member
    loss (``dice_c{k}`` per class when multiclass)."""
    if deep_supervision or bottleneck_classification:
        raise NotImplementedError(
            "deep supervision and bottleneck classification are not ported "
            "yet"
        )

    def forward(params, x):
        return torch.func.functional_call(model, params, (x,))

    apply_fn = wrap_apply(forward, precision)

    def loss_and_metrics(params, batch):
        model.train(train)
        prediction = apply_fn(params, batch["image"])
        return segmentation_loss_and_metrics(
            prediction, batch["label"], loss_fn, n_classes
        )

    return loss_and_metrics


def segmentation_loss_and_metrics(prediction, label, loss_fn: CompoundLoss,
                                  n_classes: int = 2):
    """The loss of ``prediction`` against the rounded ``label`` and the
    metrics of ``make_segmentation_step``."""
    y = torch.round(label.float())
    loss, individual = loss_fn(prediction, y)
    # soft dice for logging
    p = prediction[..., 0] if prediction.shape[-1] == 1 else prediction
    yb = y
    if yb.dim() == p.dim() + 1 and yb.shape[-1] == 1:
        yb = yb[..., 0]
    elif (
        n_classes > 2 and yb.dim() == p.dim() and yb.shape[-1] == 1
        and p.shape[-1] != 1
    ):
        yb = yb[..., 0]
    per_class = None
    if n_classes <= 2:
        inter = torch.sum(p * yb)
        denom = torch.sum(p) + torch.sum(yb)
        dice = (2 * inter + 1e-5) / (denom + 1e-5)
    else:
        oh = F.one_hot(yb.long(), n_classes).to(p.dtype)
        ax = tuple(range(p.dim() - 1))
        inter = torch.sum(p * oh, dim=ax)
        denom = torch.sum(p, dim=ax) + torch.sum(oh, dim=ax)
        per_class = (2 * inter + 1e-5) / (denom + 1e-5)
        dice = torch.mean(per_class)
    metrics = {
        "loss": loss,
        "dice": dice,
        **{f"loss_{k}": v for k, v in individual.items()},
    }
    if per_class is not None:
        for k in range(n_classes):
            metrics[f"dice_c{k}"] = per_class[k]
    return loss, metrics


def make_sliding_window_eval_step(
    model,
    loss_fn: CompoundLoss,
    window,
    n_classes: int = 2,
    precision: Optional[str] = None,
):
    """``eval_step(params, batch) -> metrics`` over whole volumes, each
    stitched from overlap-averaged ``window`` tiles (stride 0.5, 4 tiles a
    micro-batch): the geometry a crop-trained model saw. The volumes are
    stitched one after another, and the batch's stitched predictions are
    held together for the loss and the soft Dice, which are taken over the
    whole batch as the JAX step takes them (4 x 256x256x64 f32 is 64 MiB
    at one output channel)."""
    dtype = compute_dtype(precision)

    def eval_step(params, batch):
        model.eval()
        if dtype is not None:
            params = cast_floats(params, dtype)

        def fn(tiles):
            if dtype is not None:
                tiles = tiles.to(dtype)
            return torch.func.functional_call(model, params, (tiles,))

        with torch.no_grad():
            prediction = torch.stack([
                sliding_window_inference(fn, vol, tuple(window))
                for vol in batch["image"]
            ])
            _, metrics = segmentation_loss_and_metrics(
                prediction, batch["label"], loss_fn, n_classes
            )
        return _detached(metrics)

    return eval_step


def _detached(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(loss_and_metrics: Callable):
    """``train_step(state, batch) -> (state, metrics)``: value and gradient
    of the loss with respect to ``state.params``, then one optimizer
    update."""

    def train_step(state, batch):
        loss, metrics = loss_and_metrics(state.params, batch)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names])
        state = state.apply_gradients(dict(zip(names, grads)))
        return state, _detached(metrics)

    return train_step


def make_eval_step(loss_and_metrics: Callable):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_and_metrics(params, batch)
        return _detached(metrics)

    return eval_step
