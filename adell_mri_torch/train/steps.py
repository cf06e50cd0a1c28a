"""
Train and eval steps of the segmentation and classification trainers.

Counterpart of ``make_segmentation_step``, ``make_classification_step``,
``make_train_step`` and ``make_eval_step`` in
``adell_mri_tpu/train/steps.py``, with deep supervision and bottleneck
classification and without conditioning; and the sliding-window
validation step of the JAX segmentation trainer
(``--sliding_window_val``). A step runs the model as
a function of its parameters (``torch.func.functional_call``) under the
mixed-precision policy, so the f32 master parameters receive the
gradients. ``train`` puts the model in training or eval mode for the call
(dropout; a model's ``Dropout`` layers draw from the generator
``models/layers/dropout.py:seed_dropout`` gave them).

A step's ``params`` are the model's weights by ``state_dict`` name, with
the batch norms' running statistics among them when the model has any
(``TrainState.weights``): a segmentation or classification training step
returns the updated statistics in ``metrics["_variables"]``, which
``make_train_step`` carries into the state, and an eval step normalizes
by them. The precision policy casts the weights, never the statistics.
"""

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from adell_mri_torch.inference.sliding_window import sliding_window_inference
from adell_mri_torch.models.layers.adn import batch_stats, pop_batch_stats
from adell_mri_torch.models.layers.multi_resolution import resize_volume
from adell_mri_torch.models.segmentation.heads import prediction_of
from adell_mri_torch.models.segmentation.losses import (
    CompoundLoss,
    binary_cross_entropy,
    cat_cross_entropy,
)
from adell_mri_torch.train.precision import cast_floats, compute_dtype


def make_segmentation_step(
    model,
    loss_fn: CompoundLoss,
    deep_supervision: Optional[bool] = None,
    bottleneck_classification: Optional[bool] = None,
    n_classes: int = 2,
    train: bool = True,
    precision: Optional[str] = None,
):
    """Returns ``loss_and_metrics(params, batch) -> (loss, metrics)``.
    Batch keys: ``image`` [B, *S, C], ``label`` [B, *S] (or [B, *S, 1]).
    Metrics: ``loss``, the soft ``dice`` and ``loss_{name}`` per member
    loss (``dice_c{k}`` per class when multiclass). The heads are the
    model's own (``heads.py``): deep supervision adds each decoder
    output's loss against the labels resized to it by nearest, the i-th of
    t weighted ``1 / 2**(t - i) / (t + 1)``; bottleneck classification
    adds the cross entropy of the bottleneck classifier against the label
    maximum (``loss_class_loss``). ``deep_supervision`` and
    ``bottleneck_classification`` are the JAX signature's flags: given,
    each must match the model."""
    has = {flag: bool(getattr(model, flag, False))
           for flag in ("deep_supervision", "bottleneck_classification")}
    for flag, asked in (("deep_supervision", deep_supervision),
                        ("bottleneck_classification",
                         bottleneck_classification)):
        if asked is not None and bool(asked) != has[flag]:
            raise ValueError(
                f"{flag.replace('_', ' ')} "
                + ("asked of a model built without its head" if asked
                   else "turned off for a model built with its head")
            )
    deep_supervision = has["deep_supervision"]
    bottleneck_classification = has["bottleneck_classification"]
    class_loss_fn = (
        cat_cross_entropy if n_classes > 2 else binary_cross_entropy
    )

    forward = _forward_fn(model, precision)

    def loss_and_metrics(params, batch):
        model.train(train)
        out = forward(params, batch["image"])
        new_stats = pop_batch_stats(model) if train else {}
        prediction = prediction_of(out)
        y = torch.round(batch["label"].float())
        loss, metrics = segmentation_loss_and_metrics(
            prediction, batch["label"], loss_fn, n_classes
        )
        if deep_supervision:
            deep_outputs = out[2]
            t = len(deep_outputs)
            for i, o in enumerate(deep_outputs):
                ds_loss, _ = loss_fn(o, _resize_to(y, o.shape[1:-1]))
                loss = loss + ds_loss / (2 ** (t - i)) / (t + 1)
        if bottleneck_classification:
            y_class = y.reshape(y.shape[0], -1).amax(dim=1)
            act = (lambda z: torch.softmax(z, -1)) if n_classes > 2 else (
                torch.sigmoid)
            class_loss = class_loss_fn(act(out[1]), y_class)
            loss = loss + class_loss
            metrics["loss_class_loss"] = class_loss
        metrics["loss"] = loss
        if new_stats:
            metrics["_variables"] = new_stats
        return loss, metrics

    return loss_and_metrics


def _forward_fn(model, precision: Optional[str]):
    """``forward(params, *inputs)``: ``model`` as a function of its weights
    and running statistics, the weights and the inputs in the compute dtype
    and the statistics f32 (as the JAX steps keep ``batch_stats`` outside the
    precision policy's cast), float outputs back in f32."""
    stat_names = set(batch_stats(model))
    dtype = compute_dtype(precision)

    def cast(params):
        return params if dtype is None else {
            k: v if k in stat_names else cast_floats(v, dtype)
            for k, v in params.items()}

    def forward(params, *inputs, **kwargs):
        # casting weights cast already is a no-op (``.to`` of their dtype)
        if dtype is not None:
            inputs = tuple(t.to(dtype) for t in inputs)
        out = torch.func.functional_call(model, cast(params), inputs, kwargs)
        return cast_floats(out, torch.float32)

    forward.cast = cast
    return forward


def make_classification_step(
    model,
    loss_fn: Callable,
    n_classes: int = 2,
    train: bool = True,
    batch_preprocessing=None,
    precision: Optional[str] = None,
    feature_key: Optional[str] = None,
):
    """Returns ``loss_and_metrics(params, batch) -> (loss, metrics)``,
    ``loss_fn(logits, labels) -> scalar``. Batch keys: ``image`` [B, *S, C]
    and ``label`` [B]; with ``feature_key`` the model's second input, the
    tabular features [B, F] (a ``HybridClassifier``). In training
    ``batch_preprocessing`` (mixup, label smoothing) runs first, on the
    images and labels. The weights and the inputs go to the compute dtype
    and the running statistics stay f32, as the JAX step closes over its
    ``batch_stats``. Metrics: ``loss`` and ``acc`` (sigmoid above 0.5
    against labels above 0.5; argmax when multiclass, of the soft targets
    too), and in training the updated statistics in ``_variables``."""
    forward = _forward_fn(model, precision)

    def loss_and_metrics(params, batch):
        model.train(train)
        x, y = batch["image"], batch["label"]
        if batch_preprocessing is not None and train:
            x, y = batch_preprocessing(x, y)
        inputs = (x, batch[feature_key]) if feature_key else (x,)
        logits = forward(params, *inputs)
        new_stats = pop_batch_stats(model) if train else {}
        loss = loss_fn(logits, y)
        if n_classes > 2:
            y_idx = y.argmax(-1) if y.dim() == logits.dim() else y.long()
            acc = (logits.argmax(-1) == y_idx).float().mean()
        else:
            prob = torch.sigmoid(logits[..., 0] if logits.dim() > 1
                                 else logits)
            acc = ((prob > 0.5) == (y > 0.5)).float().mean()
        metrics = {"loss": loss, "acc": acc}
        if new_stats:
            metrics["_variables"] = new_stats
        return loss, metrics

    return loss_and_metrics


def _resize_to(y, spatial_shape):
    """Labels [B, *S] or [B, *S, 1] resized to ``spatial_shape`` by nearest:
    they hold class ids."""
    tail = tuple(y.shape[1 + len(spatial_shape):])
    return resize_volume(
        y, (y.shape[0],) + tuple(spatial_shape) + tail, "nearest"
    )


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
    forward = _forward_fn(model, precision)

    def eval_step(params, batch):
        model.eval()
        params = forward.cast(params)

        def fn(tiles):
            return forward(params, tiles, heads=False)

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
    of the loss with respect to ``state.params`` (the step sees the
    running statistics beside them), then one optimizer update; the
    statistics a step returns in ``metrics["_variables"]`` go into the
    state."""

    def train_step(state, batch):
        loss, metrics = loss_and_metrics(state.weights(), batch)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names])
        state = state.apply_gradients(dict(zip(names, grads)),
                                      variables=metrics.pop("_variables",
                                                            None))
        return state, _detached(metrics)

    return train_step


def make_eval_step(loss_and_metrics: Callable):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_and_metrics(params, batch)
        return _detached(metrics)

    return eval_step
