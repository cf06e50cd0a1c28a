"""
``python -m adell_mri_torch classification train``.

Counterpart of ``adell_mri_tpu/entrypoints/classification/train.py``:
dataset JSON -> config (``parse_config_cat``) -> folds, stratified by the
class label -> per fold [transforms -> cached dataset -> sampler ->
loaders -> network -> optimizer and schedule -> fit], with a checkpoint
directory per fold whose ``metadata.json`` lets ``classification test``
and ``predict`` rebuild the model and the transforms.

Ported: every ``--classification_net_type``: VGG (``vgg``), CatNet
with every ``res_type`` (``cat``, ``resnet`` or ``convnext``; batch norm,
whose running statistics the state carries and the checkpoints keep, and
batch ensembles), the standalone ConvNeXt (``convnext_backbone``,
``convnext_v2``), OrdNet (``ord``: the ordinal sigmoidal loss over its
cumulative logits, the callback's class probabilities from them), the
U-Net encoder classifier (``unet``: the config's U-Net keys) and the two
ViT classifiers (``vit``, ``factorized_vit``: built for the size the
model sees, the random crop's or the base size); ``--mask_keys`` with
``--image_masking`` and ``--image_crop_from_mask``;
``--clinical_feature_keys`` (the network headless in a
``HybridClassifier``, the features standardised by their mean and
standard deviation over the dataset, which ``metadata.json`` keeps; the
step applies the parameters alone, as the JAX CLI's does with features:
its batch norms normalise by each batch and the running statistics stay
at their initial (0, 1), which ``test`` and ``predict`` then normalise
by), binary and multiclass labels
(``--positive_labels``, ``--possible_labels``, ``--label_groups``,
``--n_classes``), ``--pad_size`` or ``--crop_size`` and
``--random_crop_size``, every augmentation flag at the classifier's
ranges (probability 0.1, flips over the first two axes, rotation of
pi/16 about the first, scale 0.1, 0.1, 0.05, a translation of 4, 4 and 1
voxels), ``--label_smoothing``, ``--mixup_alpha``, ``--partial_mixup``,
``--class_weights``, ``--weighted_sampling``,
``--correct_classification_bias``, sgd/adam/adamw under cosine annealing
with warmup, bf16 or f32 compute, ``--swa``, ``--early_stopping``,
``--resume_from_last``, ``--steps_per_epoch``, the data selection
flags and ``--resize_size`` (each volume scaled after the spacing, before
the crop or pad to ``--pad_size``, the base size where that is not
given). ``--checkpoint`` warm-starts every fold from earlier runs' best
weights (``{dir}/{name}_fold0``, or the same without the suffix: the
parameters whose JAX tree paths and shapes match and that no
``--exclude_from_state_dict`` regex names; running statistics stay the
new model's). ``--freeze_regex`` (less ``--not_freeze_regex``) gives the
parameters whose JAX tree paths match no update at all.
``--accumulate_grad_batches k`` applies the mean gradient of k steps once
every k (the schedule runs over ``steps_per_epoch // k`` updates an
epoch; the running statistics move at every step). A config with
``gaussian_process: true`` builds CatNet's GP head: after the fold's
best weights are restored, its covariance is fitted over the train
loader's batches and saved as ``gp_covariance.npy`` beside the weights,
which ``predict`` then applies. ``--calibration_ids`` (left out of the
folds) calibrates ``AdaptivePredictionSets`` at ``--conformal_alpha``
on those cases, one at a time, into ``conformal.json`` (``q_hat``,
``alpha``, ``n_calibration``). The covariance fit and the calibration
apply the parameters alone, as the JAX CLI's do: their batch norms
normalise by each batch (one case's statistics in the calibration, and
(0, 1) in the head's 1-d norms), not by the running statistics that
``test`` and ``predict`` serve with. The experiment loggers'
flags (``--logger_type`` wandb or mlflow, ``--project_name``,
``--summary_name``, ``--summary_dir``, ``--tracking_uri``,
``--log_model``) go to ``MetricLogger``: the metric CSV is always
written, the tracker too where its package is installed (without it, a
warning, then the CSV alone). An installed wandb needs an account and
network access.
"""

import json
import logging
import os

import numpy as np
import torch

from adell_mri_torch.config.factories import get_classification_network
from adell_mri_torch.config.parsing import parse_config_cat
from adell_mri_torch.data.dataset import Dataset, parse_ids
from adell_mri_torch.data.loader import CachedVolumeDataset, DataLoader
from adell_mri_torch.data.samplers import (
    RandomSampler,
    WeightedSampler,
    class_weights_from_labels,
)
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.cli_utils import (
    derive_n_classes,
    filter_training_pids,
    parse_label_groups,
    stratification_labels,
)
from adell_mri_torch.entrypoints.segmentation.train import get_folds
from adell_mri_torch.eval.callbacks import ClassificationMetricsCallback
from adell_mri_torch.models.classification.losses import (
    binary_logistic_loss,
    cross_entropy_loss,
    ordinal_sigmoidal_loss,
)
from adell_mri_torch.models.layers.adn import batch_statistics_mode
from adell_mri_torch.models.layers.conformal import AdaptivePredictionSets
from adell_mri_torch.models.layers.gaussian_process import fit_covariance
from adell_mri_torch.models.layers.dropout import seed_dropout
from adell_mri_torch.train.batch_preprocessing import BatchPreprocessing
from adell_mri_torch.train.checkpoints import (
    MODEL_FILE,
    CheckpointManager,
    correct_classification_bias,
    freeze_mask_by_regex,
    warm_start,
)
from adell_mri_torch.train.logging_utils import metric_logger_of
from adell_mri_torch.train.loop import TrainLoop
from adell_mri_torch.train.optim import (
    accumulate_gradients,
    freeze_wrap,
    get_optimizer,
)
from adell_mri_torch.train.precision import compute_dtype
from adell_mri_torch.train.schedules import cosine_annealing_with_warmup
from adell_mri_torch.train.state import TrainState
from adell_mri_torch.train.steps import (
    make_classification_step,
    make_eval_step,
    make_train_step,
)
from adell_mri_torch.transforms.pipeline import (
    AugmentPolicy,
    ClassificationTransforms,
)

logger = logging.getLogger(__name__)


def parameters_alone(loss_and_metrics, model, train: bool):
    """The JAX CLI's step with clinical features, which applies the
    parameters alone: ``loss_and_metrics`` (``make_classification_step``)
    with the batch norms normalising by each batch in training and in
    eval (``batch_statistics_mode``; ``(0, 1)`` where a feature has one
    element) and no statistics returned, so the state keeps the ones it
    started with."""

    def step(params, batch):
        if not train:
            with batch_statistics_mode(model):
                return loss_and_metrics(params, batch)
        loss, metrics = loss_and_metrics(params, batch)
        metrics.pop("_variables", None)
        return loss, metrics

    return step


def _params_alone(model, *inputs, **kwargs):
    """The f32 forward of the JAX CLI's ``apply({"params": ...})`` in
    eval: batch norms by each batch's statistics."""
    with torch.no_grad(), batch_statistics_mode(model):
        return model(*inputs, **kwargs)


def fit_gp_covariance(model, loader, device, out_dir: str):
    """The GP head's covariance (``fit_covariance``) over the random
    features of ``loader``'s batches, to ``gp_covariance.npy``."""
    phis = [_params_alone(model, torch.from_numpy(b["image"]).to(device),
                          return_phi=True)[1] for b in loader]
    if phis:
        cov = fit_covariance(torch.cat(phis))
        np.save(os.path.join(out_dir, "gp_covariance.npy"),
                cov.cpu().numpy())
        logger.info("GP covariance fitted over %d batches", len(phis))


def calibrate(model, data, calibration_ids, load_fn, device,
              n_classes: int, alpha: float, features: bool, out_dir: str):
    """``AdaptivePredictionSets`` at ``alpha`` on the calibration cases,
    one forward each (the softmax, or the sigmoid's two classes), to
    ``conformal.json``."""
    pids = [p for p in parse_ids(calibration_ids, "list")
            if p in data.dataset]
    probs, labels = [], []
    for entry in data.to_datalist(pids):
        sample = load_fn(entry)
        inputs = [torch.from_numpy(sample["image"])[None].to(device)]
        if features:
            inputs.append(torch.from_numpy(sample["features"])[None]
                          .to(device))
        logits = _params_alone(model, *inputs)[0].float().cpu()
        if n_classes == 2:
            p1 = float(torch.sigmoid(logits[0]))
            probs.append([1.0 - p1, p1])
        else:
            probs.append(torch.softmax(logits, -1).tolist())
        labels.append(int(sample["label"]))
    if not probs:
        return
    aps = AdaptivePredictionSets(alpha=alpha).calibrate(
        np.asarray(probs), np.asarray(labels))
    with open(os.path.join(out_dir, "conformal.json"), "w") as f:
        json.dump({"q_hat": aps.q_hat, "alpha": aps.alpha,
                   "n_calibration": len(probs)}, f)
    logger.info("conformal calibrated on %d cases (q_hat=%.4f)", len(probs),
                aps.q_hat)


ARG_KEYS = [
    "dataset_json",
    "image_keys",
    ("label_keys", "label_keys", dict(nargs=None, default="label")),
    "adc_keys",
    "filter_on_keys",
    "possible_labels",
    "positive_labels",
    "label_groups",
    "cache_rate",
    "cache_dir",
    "subsample_size",
    "subsample_training_data",
    "excluded_ids_from_training_data",
    "n_folds",
    "folds",
    "target_spacing",
    "pad_size",
    "crop_size",
    "resize_size",
    "random_crop_size",
    "config_file",
    "dev",
    "n_workers",
    "seed",
    "max_epochs",
    "warmup_steps",
    "n_classes",
    "augment",
    "label_smoothing",
    "mixup_alpha",
    "partial_mixup",
    "dropout_param",
    "batch_size",
    "learning_rate",
    "optimizer",
    "precision",
    "accumulate_grad_batches",
    "gradient_clip_val",
    "check_val_every_n_epoch",
    "early_stopping",
    "class_weights",
    "weighted_sampling",
    "checkpoint_dir",
    "checkpoint_name",
    "resume_from_last",
    "monitor",
    "metric_path",
    "correct_classification_bias",
    "checkpoint",
    "exclude_from_state_dict",
    "freeze_regex",
    "not_freeze_regex",
    "classification_net_type",
    "swa",
    "steps_per_epoch",
    "calibration_ids",
    "conformal_alpha",
    "clinical_feature_keys",
    "mask_keys",
    "image_masking",
    "image_crop_from_mask",
    "logger_type",
    "project_name",
    "summary_name",
    "summary_dir",
    "tracking_uri",
    "log_model",
]


def label_arguments(args, n_classes: int):
    """The label mapping of the transforms (and of ``metadata.json``):
    ``positive_labels`` binarize a binary task with enumerable labels,
    ``possible_labels`` index the values otherwise, ``label_groups``
    group them."""
    return dict(
        positive_labels=(list(args.positive_labels)
                         if args.positive_labels and n_classes == 2
                         and args.possible_labels else None),
        possible_labels=(list(args.possible_labels)
                         if args.possible_labels and not args.positive_labels
                         else None),
        label_groups=parse_label_groups(args.label_groups),
    )


def main(arguments):
    parser = Parser(prog="adell classification train")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    net_type = args.classification_net_type
    device = use_device(args.dev)
    compute_dtype(args.precision)  # an unknown precision fails here
    label_key = args.label_keys

    data = Dataset(args.dataset_json, seed=args.seed)
    data.apply_filters(
        presence_keys=list(args.image_keys) + [label_key],
        filter_on_keys=args.filter_on_keys,
        possible_labels=args.possible_labels,
        label_keys=label_key if args.possible_labels else None,
    )
    if args.subsample_size:
        data.subsample_dataset(subsample_size=args.subsample_size,
                               strata_key=label_key)
    if len(data) == 0:
        raise ValueError("no samples left after filtering")

    config = parse_config_cat(args.config_file)
    net_cfg, train_cfg = config["network"], config["training"]
    batch_size = args.batch_size or train_cfg.get("batch_size", 4)
    learning_rate = args.learning_rate or train_cfg.get("learning_rate", 1e-3)
    weight_decay = train_cfg.get("weight_decay", 0.0)
    if args.dropout_param:
        net_cfg["dropout_param"] = args.dropout_param

    # the HybridClassifier's standardisation: over every case that has
    # all the features, the population standard deviation
    feat_keys = list(args.clinical_feature_keys or [])
    feat_means = feat_stds = None
    if feat_keys:
        mat = np.asarray([[float(data[k][fk]) for fk in feat_keys]
                          for k in data
                          if all(fk in data[k] for fk in feat_keys)])
        feat_means, feat_stds = mat.mean(0).tolist(), mat.std(0).tolist()

    base_size = args.pad_size or args.resize_size or args.crop_size
    if base_size is None:
        raise ValueError(
            "one of --pad_size/--resize_size/--crop_size is required")
    crop_size = args.random_crop_size

    pids = list(data.keys())
    if args.calibration_ids:
        calib_set = set(parse_ids(args.calibration_ids, "list"))
        pids = [p for p in pids if p not in calib_set]
    folds = get_folds(
        pids, args.n_folds, args.seed, args.folds,
        labels=stratification_labels(data, pids, label_key, args.n_folds,
                                     args.folds),
    )
    metric_logger = metric_logger_of(args)
    mode = "min" if "loss" in args.monitor else "max"

    n_classes = derive_n_classes(args)
    labels_args = label_arguments(args, n_classes)
    mask_args = dict(mask_key=(args.mask_keys or [None])[0],
                     image_masking=bool(args.image_masking),
                     image_crop_from_mask=bool(args.image_crop_from_mask))
    if net_type == "ord":

        def loss_fn(logits, y):
            return ordinal_sigmoidal_loss(logits, y, n_classes)
    elif n_classes > 2:
        weights = (np.asarray(args.class_weights, np.float32)
                   if args.class_weights else None)

        def loss_fn(logits, y):
            return cross_entropy_loss(logits, y, weight=weights)
    else:
        w = args.class_weights[0] if args.class_weights else None

        def loss_fn(logits, y):
            return binary_logistic_loss(logits, y, weight=w)

    batch_prep = None
    if args.mixup_alpha or args.label_smoothing:
        batch_prep = BatchPreprocessing(
            label_smoothing_param=args.label_smoothing,
            mixup_alpha=args.mixup_alpha,
            partial_mixup_fraction=args.partial_mixup,
            seed=args.seed,
            # the JAX CLI passes --n_classes, not the derived class count
            n_classes=args.n_classes,
        )

    for fold_idx, (train_pids, val_pids) in enumerate(folds):
        train_pids = filter_training_pids(
            train_pids,
            excluded=args.excluded_ids_from_training_data,
            subsample_fraction=args.subsample_training_data,
            seed=args.seed,
            fold_idx=fold_idx,
        )
        logger.info("fold %d: %d train / %d val", fold_idx, len(train_pids),
                    len(val_pids))
        transforms = ClassificationTransforms(
            image_keys=args.image_keys,
            label_key=label_key,
            target_spacing=args.target_spacing,
            target_size=base_size,
            resize_size=args.resize_size,
            crop_size=crop_size,
            adc_keys=args.adc_keys or (),
            augmentations=AugmentPolicy.classification(
                args.augment, crop_size or base_size),
            seed=args.seed + fold_idx,
            clinical_feature_keys=feat_keys,
            **labels_args,
            **mask_args,
        )
        load_fn = transforms.load_fn()
        train_list = data.to_datalist(train_pids)
        cache = dict(cache_rate=args.cache_rate, cache_dir=args.cache_dir,
                     cache_fingerprint=repr(transforms))
        train_ds = CachedVolumeDataset(train_list, load_fn, **cache)
        val_ds = CachedVolumeDataset(data.to_datalist(val_pids), load_fn,
                                     **cache)
        if args.weighted_sampling:
            sampler = WeightedSampler(
                class_weights_from_labels([e[label_key] for e in train_list]),
                seed=args.seed)
        else:
            sampler = RandomSampler(len(train_ds), seed=args.seed)
        train_loader = DataLoader(
            train_ds, sampler=sampler, batch_size=batch_size,
            drop_last=True, prefetch=max(args.n_workers, 2),
        )
        val_loader = DataLoader(
            val_ds, batch_size=max(1, min(batch_size, len(val_ds))),
            drop_last=True, prefetch=1,
        )

        torch.manual_seed(args.seed)
        model = get_classification_network(
            net_type, net_cfg, n_classes=n_classes,
            in_channels=len(args.image_keys),
            clinical_feature_means=feat_means,
            clinical_feature_stds=feat_stds,
            image_size=crop_size or base_size,
        ).to(device)
        seed_dropout(
            model,
            torch.Generator(device=device).manual_seed(args.seed + fold_idx),
        )
        if args.correct_classification_bias and n_classes <= 2:
            correct_classification_bias(
                dict(model.named_parameters()),
                [float(e[label_key]) for e in train_list])
        for ck_path in args.checkpoint or []:
            warm_start(model, ck_path, args.exclude_from_state_dict)

        steps_per_epoch = max(len(train_loader), 1)
        if args.steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
        # the optimizer and its schedule advance once per accumulation
        schedule = cosine_annealing_with_warmup(
            learning_rate,
            t_max=args.max_epochs * max(
                1, steps_per_epoch // max(1, args.accumulate_grad_batches)),
            n_warmup_steps=args.warmup_steps,
        )

        def make_tx(params):
            tx = get_optimizer(
                args.optimizer, learning_rate=schedule,
                weight_decay=weight_decay, clip_norm=args.gradient_clip_val,
                params=params,
            )
            if args.freeze_regex or args.not_freeze_regex:
                tx = freeze_wrap(tx, freeze_mask_by_regex(
                    params, args.freeze_regex or (),
                    args.not_freeze_regex or ()))
            return accumulate_gradients(tx, args.accumulate_grad_batches)

        state = TrainState.create(
            model,
            make_tx,
            # SWA averages the last quarter of the steps
            swa_start_step=(int(0.75 * args.max_epochs * steps_per_epoch)
                            if args.swa else None),
        )
        ckpt = CheckpointManager(
            args.checkpoint_dir,
            name=args.checkpoint_name or "classification",
            fold=fold_idx,
            monitor=args.monitor,
            mode=mode,
            metadata={
                "network_config": net_cfg,
                "transform_arguments": {
                    "image_keys": list(args.image_keys),
                    "label_key": label_key,
                    "target_spacing": args.target_spacing,
                    "target_size": list(base_size),
                    "resize_size": (list(args.resize_size)
                                    if args.resize_size else None),
                    "clinical_feature_keys": feat_keys,
                    **labels_args,
                    "adc_keys": list(args.adc_keys or ()),
                    **mask_args,
                },
                "train_pids": train_pids,
                "val_pids": val_pids,
                "n_classes": n_classes,
                "net_type": net_type,
                "clinical_feature_means": feat_means,
                "clinical_feature_stds": feat_stds,
            },
        )
        ckpt.begin_run(resume=args.resume_from_last)
        if (args.resume_from_last
                and ckpt.status(args.max_epochs) == "finished"):
            logger.info("fold %d already finished; skipping", fold_idx)
            continue
        step_kwargs = dict(
            n_classes=n_classes, precision=args.precision,
            feature_key="features" if feat_keys else None)
        train_lm = make_classification_step(
            model, loss_fn, train=True, batch_preprocessing=batch_prep,
            **step_kwargs)
        eval_lm = make_classification_step(model, loss_fn, train=False,
                                           **step_kwargs)
        if feat_keys:
            train_lm = parameters_alone(train_lm, model, train=True)
            eval_lm = parameters_alone(eval_lm, model, train=False)
        loop = TrainLoop(
            train_step=make_train_step(train_lm),
            eval_step=make_eval_step(eval_lm),
            augment_fn=transforms.augment,
            device=device,
            max_epochs=args.max_epochs,
            check_val_every_n_epoch=args.check_val_every_n_epoch,
            early_stopping=args.early_stopping,
            monitor=args.monitor,
            mode=mode,
            ckpt_manager=ckpt,
            metric_logger=metric_logger,
            seed=args.seed + fold_idx,
            eval_on_ema=args.swa,
            callbacks=[ClassificationMetricsCallback(
                model, n_classes,
                feature_key="features" if feat_keys else None,
                ordinal=net_type == "ord")],
            steps_per_epoch=args.steps_per_epoch,
        )
        start_epoch = 0
        if args.resume_from_last:
            state, start_epoch = ckpt.resume(state)
            if start_epoch:
                logger.info("fold %d: resuming from epoch %d", fold_idx,
                            start_epoch)
        state, history = loop.fit(state, train_loader, val_loader,
                                  start_epoch=start_epoch)
        final = history[-1] if history else {}
        if args.log_model:
            metric_logger.log_artifact(ckpt.dir)
        logger.info("fold %d done: %s", fold_idx,
                    json.dumps(final, default=float))
        gp = bool(net_cfg.get("gaussian_process")) and not feat_keys
        if not (gp or args.calibration_ids):
            continue
        # fitted on the weights test and predict serve: the best epoch's
        if os.path.exists(os.path.join(ckpt.dir, MODEL_FILE)):
            best = ckpt.load_state_dict()
            with torch.no_grad():
                for k, v in state.params.items():
                    v.copy_(best[k])
        model.eval()
        if gp:
            fit_gp_covariance(model, train_loader, device, ckpt.dir)
        if args.calibration_ids:
            calibrate(model, data, args.calibration_ids, load_fn, device,
                      n_classes, args.conformal_alpha, bool(feat_keys),
                      ckpt.dir)
