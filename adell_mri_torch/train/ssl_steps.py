"""
Self-supervised train steps.

Counterpart of ``make_two_view_step``, ``make_ssl_train_step``,
``make_dino_step``, ``make_ibot_step``, ``make_vicregl_step``,
``make_mae_step`` and ``make_ijepa_step`` in
``adell_mri_tpu/train/ssl_steps.py``.

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

- DINO (``view1``, ``view2`` and, with multi-crop, ``local_crops`` [B,
  n, *small, C]): the teacher (the EMA shadow, else the parameters) sees
  the two views without gradient, the student the two views and every
  local crop; the loss is the mean of ``dino_loss`` over the pairs of a
  teacher view and a student view that is not the same view, and the
  centre (``dino_center`` in the state's ``variables``) becomes the mean
  of the pairs' new centres.
- iBOT: the student sees each view with one block mask a sample
  (``batch["masks1"]``/``["masks2"]`` [B, N], else drawn from
  ``generator``), the teacher the views unmasked; the loss is the
  cross-view ``dino_loss`` of the mean logits (centre
  ``ibot_center_global``) plus the token cross-entropy at the masked
  positions of each view (centre ``ibot_center_mask``, moved towards the
  teacher's mean token logits).
- VICRegL (``view{1,2}`` and ``view{1,2}_mat``): the two ``ret="local"``
  forwards; each local feature's position is its grid cell's centre in
  the view mapped through the view's matrix into the input volume. The
  JAX step applies the parameters alone, so its batch norms normalise by
  each batch and keep no running statistics: the port's step drops them
  too, and the state's statistics stay as they were.
- MAE (``batch["image"]``, else ``view1``): the masking noise
  ``batch["noise"]`` [B, N] or drawn from ``generator``.

The centres ride in the state's ``variables`` beside the running
statistics (``CENTRES``); a step takes them out of the weights before the
forward.

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

#: methods whose teacher is always the EMA shadow
EMA_METHODS = ("byol", "ijepa", "dino", "ibot")
#: methods that read the base-size image instead of two views
IMAGE_METHODS = ("ijepa", "mae")
#: the centres DINO and iBOT keep in the state's variables, not weights
METHOD_CENTRES = {"dino": ("dino_center",),
                  "ibot": ("ibot_center_global", "ibot_center_mask")}
CENTRES = sum(METHOD_CENTRES.values(), ())


def initial_centres(method: str, out_dim: int, device=None):
    """The centres ``method`` keeps in the state's variables at the start
    of a run: zeros of ``out_dim``."""
    return {name: torch.zeros(out_dim, device=device)
            for name in METHOD_CENTRES.get(method, ())}


def without_centres(params):
    """``params`` (a state's weights, a checkpoint's state dict) without
    the centres: what the network takes."""
    return {k: v for k, v in params.items() if k not in CENTRES}


def _split_centres(params):
    """(the weights a forward takes, the centres among ``params``)."""
    return (without_centres(params),
            {k: params[k] for k in CENTRES if k in params})


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


def make_dino_step(model, use_sinkhorn: bool = False,
                   student_temp: float = 0.1, teacher_temp: float = 0.04,
                   center_momentum: float = 0.9,
                   precision: Optional[str] = None):
    """Returns ``loss_and_metrics(params, batch, ema_params=None)``: DINO's
    multi-crop loss; metrics ``loss`` and the new centre in
    ``_variables``."""
    forward = _forward_fn(model, precision)

    def loss_and_metrics(params, batch, ema_params=None):
        model.train(True)
        weights, centres = _split_centres(params)
        center = centres.get("dino_center")
        if center is None:
            raise ValueError("DINO needs dino_center (zeros of out_dim) in "
                             "the train state's variables")
        teacher = weights if ema_params is None else ema_params
        views = (batch["view1"], batch["view2"])
        with torch.no_grad():
            t_out = [forward(teacher, v) for v in views]
        s_out = [forward(weights, v) for v in views]
        crops = batch.get("local_crops")
        s_local = [] if crops is None else [
            forward(weights, crops[:, i]) for i in range(crops.shape[1])]
        total, n_pairs = 0.0, 0
        new_center = torch.zeros_like(center)
        for ti, t in enumerate(t_out):
            students = [s for si, s in enumerate(s_out) if si != ti]
            for s in students + s_local:
                loss, c = L.dino_loss(
                    s, t, center, student_temp, teacher_temp,
                    center_momentum=center_momentum,
                    use_sinkhorn=use_sinkhorn)
                total, n_pairs = total + loss, n_pairs + 1
                new_center = new_center + c
        loss = total / max(n_pairs, 1)
        return loss, {"loss": loss, "_variables": {
            "dino_center": (new_center / max(n_pairs, 1)).detach()}}

    return loss_and_metrics


def make_ibot_step(model, student_temp: float = 0.1,
                   teacher_temp: float = 0.04, center_momentum: float = 0.9,
                   precision: Optional[str] = None,
                   generator: Optional[torch.Generator] = None):
    """Returns ``loss_and_metrics(params, batch, ema_params=None)``: iBOT's
    global and masked-token losses; metrics ``loss``, ``loss_global``,
    ``loss_mask`` and the two new centres in ``_variables``."""
    forward = _forward_fn(model, precision)

    def token_ce(s_tok, t_tok, m, center):
        t_probs = torch.softmax((t_tok - center) / teacher_temp, dim=-1)
        s_logp = torch.log_softmax(s_tok / student_temp, dim=-1)
        ce = -torch.sum(t_probs * s_logp, dim=-1)
        return torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)

    def loss_and_metrics(params, batch, ema_params=None):
        model.train(True)
        weights, centres = _split_centres(params)
        cg = centres.get("ibot_center_global")
        cm = centres.get("ibot_center_mask")
        if cg is None or cm is None:
            raise ValueError("iBOT needs ibot_center_global and "
                             "ibot_center_mask (zeros of out_dim) in the "
                             "train state's variables")
        teacher = weights if ema_params is None else ema_params
        v1, v2 = batch["view1"], batch["view2"]
        masks = [batch.get("masks1"), batch.get("masks2")]
        for i, v in enumerate((v1, v2)):
            if masks[i] is None:
                masks[i] = model.draw_masks(v, generator)
        s_red1, s_tok1, m1 = forward(weights, v1, mask=True, masks=masks[0])
        s_red2, s_tok2, m2 = forward(weights, v2, mask=True, masks=masks[1])
        with torch.no_grad():
            t_red1, t_tok1, _ = forward(teacher, v1)
            t_red2, t_tok2, _ = forward(teacher, v2)
        kw = dict(center_momentum=center_momentum)
        lg1, c1 = L.dino_loss(s_red1, t_red2, cg, student_temp,
                              teacher_temp, **kw)
        lg2, c2 = L.dino_loss(s_red2, t_red1, cg, student_temp,
                              teacher_temp, **kw)
        loss_global = 0.5 * (lg1 + lg2)
        loss_mask = 0.5 * (token_ce(s_tok1, t_tok1, m1, cm)
                           + token_ce(s_tok2, t_tok2, m2, cm))
        tok_mean = 0.5 * (torch.mean(t_tok1, dim=(0, 1))
                          + torch.mean(t_tok2, dim=(0, 1)))
        loss = loss_global + loss_mask
        return loss, {
            "loss": loss, "loss_global": loss_global, "loss_mask": loss_mask,
            "_variables": {
                "ibot_center_global": (0.5 * (c1 + c2)).detach(),
                "ibot_center_mask": (cm * center_momentum + tok_mean * (
                    1 - center_momentum)).detach()}}

    return loss_and_metrics


def local_coords(local, view_shape, mat):
    """The input-volume position of each cell of a feature map ``local``
    [B, *g, F] of a view of ``view_shape``: the cell's centre in the view
    mapped through the view's matrix ``mat`` [B, ndim + 1, ndim + 1];
    [B, N, ndim], the products summed in the order of the matrix's
    columns."""
    g = local.shape[1:-1]
    ndim = len(g)
    dev = local.device
    stride = torch.tensor([s / gi for s, gi in zip(view_shape, g)],
                          dtype=torch.float32, device=dev)
    mesh = torch.stack(torch.meshgrid(
        *[torch.arange(gi, dtype=torch.float32, device=dev) for gi in g],
        indexing="ij"), dim=-1).reshape(-1, ndim)
    centers = mesh * stride + stride / 2.0
    homo = torch.cat([centers, torch.ones((centers.shape[0], 1),
                                          device=dev)], dim=-1)
    mat = mat.float()
    out = mat[:, None, :ndim, 0] * homo[None, :, None, 0]
    for j in range(1, ndim + 1):
        out = out + mat[:, None, :ndim, j] * homo[None, :, None, j]
    return out


def make_vicregl_step(model, alpha: float = 0.75, top_k: int = 4,
                      loss_kwargs: Optional[dict] = None,
                      precision: Optional[str] = None):
    """Returns ``loss_and_metrics(params, batch, ema_params=None)``: VICRegL
    over the two views and their matrices; metrics ``loss`` and VICReg's
    components with ``local``. No running statistics are kept."""
    loss_kwargs = loss_kwargs or {}
    forward = _forward_fn(model, precision)

    def loss_and_metrics(params, batch, ema_params=None):
        model.train(True)
        out = []
        for name in ("view1", "view2"):
            v = batch[name]
            z, local = forward(params, v, ret="local")
            # the JAX step's stateless batch norms update nothing
            pop_batch_stats(model)
            flat = local.reshape(local.shape[0], -1, local.shape[-1])
            out.append((z, flat, local_coords(local, v.shape[1:-1],
                                              batch[f"{name}_mat"])))
        (z1, l1, c1), (z2, l2, c2) = out
        loss, comp = L.vicregl_loss(z1, z2, l1, l2, c1, c2, alpha=alpha,
                                    top_k=top_k, **loss_kwargs)
        return loss, {"loss": loss, **comp}

    return loss_and_metrics


def make_mae_step(model, precision: Optional[str] = None,
                  generator: Optional[torch.Generator] = None):
    """Returns ``loss_and_metrics(params, batch, ema_params=None)``: the
    MAE reconstruction loss on the masked patches."""
    forward = _forward_fn(model, precision)

    def loss_and_metrics(params, batch, ema_params=None):
        model.train(True)
        x = batch["image"] if "image" in batch else batch["view1"]
        noise = batch.get("noise")
        pred, target, mask = forward(
            params, x, noise=noise,
            generator=generator if noise is None else None)
        loss = L.mae_loss(pred, target, mask)
        return loss, {"loss": loss}

    return loss_and_metrics


def make_method_step(model, method: str, precision: Optional[str] = None,
                     generator: Optional[torch.Generator] = None,
                     ema_teacher: bool = False, stop_gradient: bool = False):
    """``ssl train``'s step of ``--ssl_method method``: the masks and noise
    of I-JEPA, iBOT and MAE drawn from ``generator``; ``ema_teacher`` and
    ``stop_gradient`` for the two-view methods."""
    if method == "ijepa":
        return make_ijepa_step(model, precision, generator)
    if method == "mae":
        return make_mae_step(model, precision, generator)
    if method == "dino":
        return make_dino_step(model, precision=precision)
    if method == "ibot":
        return make_ibot_step(model, precision=precision,
                              generator=generator)
    if method == "vicregl":
        return make_vicregl_step(model, precision=precision)
    return make_two_view_step(model, method=method, ema_teacher=ema_teacher,
                              stop_gradient=stop_gradient,
                              precision=precision)


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
