"""
``python -m adell_mri_torch segmentation train``.

Counterpart of ``adell_mri_tpu/entrypoints/segmentation/train.py``:
dataset JSON -> config -> folds -> per fold [transforms -> cached dataset
-> sampler -> loaders -> network -> optimizer and schedule -> fit], with
a checkpoint directory per fold whose ``metadata.json`` lets
``segmentation predict`` rebuild the model and the transforms.

Ported: the 3D U-Net, UNETR and SWIN-UNet (``--segmentation_net_type
unet``, ``unetr``, ``monai_unetr``, ``swin`` or ``monai_swin``; UNETR is
built for the ``--pad_size`` volume), ``--deep_supervision`` and
``--bottleneck_classification`` for all three, whole-volume training or,
for the U-Net and SWIN-UNet, pos/neg crops of ``--random_crop_size`` from
the padded volume, dropout drawn from a
generator seeded with ``--seed``, every augmentation flag (intensity,
noise, rbf, affine, shear, flip, blur, distort, lowres, trivial), the
data selection (``--filter_on_keys`` with ``--filter_is_optional``,
``--excluded_ids``, ``--subsample_size``, ``--folds``,
``--excluded_ids_from_training_data``, ``--subsample_training_data``,
``--constant_ratio``, ``--validation_samples_per_epoch``, ``--cache_dir``,
``--possible_labels`` for the class count), sgd/adam/adamw under cosine
annealing with warmup,
bf16 or f32 compute, ``--swa`` (validation on the weight average of the
last quarter of the steps), ``--check_nan_loss``, ``--early_stopping``,
``--resume_from_last`` (a finished fold is skipped, an interrupted one
continues from its last epoch), ``--sliding_window_val`` (whole volumes
stitched from crop-size windows) and ``--picai_eval`` (V_AP, V_AUC,
V_score each validation). Fine-tuning: ``--res_config_file`` (an SSL
yaml's ``backbone_args``) makes the U-Net's encoder that ResNet backbone
(``encoder_structure``, ``depth`` ``[stem_f, *stage_channels]``, kernels
of 3, strides ``[2, *maxpool_structure]``, its ``res_type``),
``--encoder_checkpoint`` loads it from a port run (``subtree_warm_start``),
``--checkpoint`` with ``--exclude_from_state_dict`` warm-starts the whole
network (``warm_start``), ``--lr_encoder`` scales the updates of
``^(enc_|encoder_backbone)`` by its ratio to the learning rate
(``lr_scale_by_regex``), ``--freeze_regex``/``--not_freeze_regex`` freeze
leaves, ``--accumulate_grad_batches k`` applies the mean of k steps'
gradients (the schedule counts optimizer steps) and ``--resize_size``
scales each volume after the spacing. The experiment loggers' flags go
to ``MetricLogger`` (``train/logging_utils.py``: the CSV always, wandb
or MLflow where installed; with ``--log_model`` each fold's checkpoint
directory is uploaded). Every other flag is parsed and raises
``NotImplementedError`` when given a value other than its default.
"""

import json
import logging
from typing import List

import numpy as np
import torch

from adell_mri_torch.config.factories import get_segmentation_network
from adell_mri_torch.config.parsing import (
    load_yaml,
    parse_config_unet,
    resnet_encoder_config,
)
from adell_mri_torch.data.dataset import Dataset, parse_ids
from adell_mri_torch.data.loader import CachedVolumeDataset, DataLoader
from adell_mri_torch.data.samplers import (
    PartiallyRandomSampler,
    RandomSampler,
)
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.cli_utils import filter_training_pids
from adell_mri_torch.eval.callbacks import LesionEvalCallback
from adell_mri_torch.models.layers.dropout import seed_dropout
from adell_mri_torch.train.checkpoints import (
    ENCODER_SOURCES,
    CheckpointManager,
    freeze_mask_by_regex,
    subtree_warm_start,
    warm_start,
)
from adell_mri_torch.train.logging_utils import metric_logger_of
from adell_mri_torch.train.loop import TrainLoop
from adell_mri_torch.train.nan_guard import NaNGuard
from adell_mri_torch.train.optim import (
    accumulate_gradients,
    freeze_wrap,
    get_optimizer,
    lr_scale_by_regex,
)
from adell_mri_torch.train.precision import compute_dtype
from adell_mri_torch.train.schedules import cosine_annealing_with_warmup
from adell_mri_torch.train.state import TrainState
from adell_mri_torch.train.steps import (
    make_eval_step,
    make_segmentation_step,
    make_sliding_window_eval_step,
    make_train_step,
)
from adell_mri_torch.transforms.host import (
    get_spacing_quantile,
    spacing_values_from_dataset_json,
)
from adell_mri_torch.transforms.pipeline import (
    AugmentPolicy,
    SegmentationTransforms,
)

logger = logging.getLogger(__name__)

NET_TYPES = ("unet", "unetr", "monai_unetr", "swin", "monai_swin")
ARG_KEYS = [
    "dataset_json",
    "image_keys",
    "mask_keys",
    "adc_keys",
    "positive_labels",
    "cache_rate",
    "val_from_train",
    "n_folds",
    "target_spacing",
    "pad_size",
    "crop_size",
    "random_crop_size",
    "config_file",
    "dev",
    "n_workers",
    "seed",
    "max_epochs",
    "warmup_steps",
    "start_decay",
    "n_classes",
    "augment",
    "dropout_param",
    "batch_size",
    "learning_rate",
    "loss_gamma",
    "loss_comb",
    "steps_per_epoch",
    "dataset_iterations_per_epoch",
    "samples_per_epoch",
    "optimizer",
    "precision",
    "gradient_clip_val",
    "check_val_every_n_epoch",
    "checkpoint_dir",
    "checkpoint_name",
    "monitor",
    "metric_path",
    "segmentation_net_type",
    "swa",
    "check_nan_loss",
    "early_stopping",
    "resume_from_last",
    "sliding_window_val",
    "picai_eval",
    "filter_on_keys",
    "filter_is_optional",
    "possible_labels",
    "excluded_ids",
    "excluded_ids_from_training_data",
    "cache_dir",
    "subsample_size",
    "subsample_training_data",
    "folds",
    "validation_samples_per_epoch",
    "constant_ratio",
    "bottleneck_classification",
    "deep_supervision",
    "resize_size",
    "lr_encoder",
    "accumulate_grad_batches",
    "checkpoint",
    "res_config_file",
    "encoder_checkpoint",
    "exclude_from_state_dict",
    "freeze_regex",
    "not_freeze_regex",
    "logger_type",
    "project_name",
    "summary_name",
    "summary_dir",
    "tracking_uri",
    "log_model",
]
UNPORTED_KEYS = [
    "skip_keys",
    "feature_keys",
    "delete_checkpoints",
    "profile_dir",
    "semi_supervised",
    "semi_sl_weight",
    "missing_to_empty",
    "remat",
    "remat_policy",
]

# the encoder a --res_config_file grafts, whose updates --lr_encoder scales
ENCODER_REGEX = r"^(enc_|encoder_backbone)"


def kfold_split(n: int, n_folds: int, seed: int):
    """Shuffled K-fold over ``range(n)``: the splits of scikit-learn's
    ``KFold(n_folds, shuffle=True, random_state=seed)``, which the JAX
    package uses (the first ``n % n_folds`` folds hold one more)."""
    if n_folds > n:
        raise ValueError(f"{n_folds} folds need at least {n_folds} cases")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_folds, n // n_folds)
    sizes[: n % n_folds] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def stratified_kfold_split(labels, n_folds: int, seed: int):
    """Shuffled stratified K-fold over ``labels``: the splits of
    scikit-learn's ``StratifiedKFold(n_folds, shuffle=True,
    random_state=seed)``, which the JAX package uses. Classes are numbered
    by first appearance; each class's members are dealt to the folds in
    the round-robin counts of the sorted labels, the fold numbers shuffled
    per class by one ``RandomState(seed)``."""
    _, first, inverse = np.unique(np.asarray(labels), return_index=True,
                                  return_inverse=True)
    _, class_perm = np.unique(first, return_inverse=True)
    encoded = class_perm[inverse.reshape(-1)]
    n_classes = len(first)
    if np.all(n_folds > np.bincount(encoded)):
        raise ValueError(f"{n_folds} folds need more members in a class")
    ordered = np.sort(encoded)
    allocation = np.asarray([
        np.bincount(ordered[i::n_folds], minlength=n_classes)
        for i in range(n_folds)
    ])
    rng = np.random.RandomState(seed)
    test_folds = np.empty(len(encoded), dtype=np.int64)
    for k in range(n_classes):
        folds_for_class = np.arange(n_folds).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[encoded == k] = folds_for_class
    for i in range(n_folds):
        yield np.flatnonzero(test_folds != i), np.flatnonzero(test_folds == i)


def get_folds(pids: List[str], n_folds: int, seed: int, explicit=None,
              val_fraction=None, labels=None):
    """K-fold split; with ``n_folds <= 1`` one split whose validation share
    is ``val_fraction`` (0.2 by default). ``explicit`` (``--folds``: one
    ID list, file or comma-separated string per fold) gives each fold's
    validation IDs instead; the rest of ``pids`` trains. ``labels`` (one a
    pid) stratifies the K folds by class, as the classifiers' are."""
    if explicit:
        folds = []
        for val_ids in parse_ids(explicit, "nested_list"):
            val_set = set(val_ids)
            folds.append(([p for p in pids if p not in val_set],
                          [p for p in pids if p in val_set]))
        return folds
    pids_arr = np.asarray(pids)
    if n_folds <= 1:
        idx = np.random.default_rng(seed).permutation(len(pids_arr))
        frac = 0.2 if val_fraction is None else val_fraction
        n_val = max(1, int(frac * len(pids_arr)))
        return [
            (pids_arr[idx[n_val:]].tolist(), pids_arr[idx[:n_val]].tolist())
        ]
    if val_fraction is not None:
        logger.warning(
            "--val_from_train only applies with --n_folds <= 1; k-fold "
            "validation splits are 1/n_folds"
        )
    splits = (kfold_split(len(pids_arr), n_folds, seed) if labels is None
              else stratified_kfold_split(labels, n_folds, seed))
    return [
        (pids_arr[tr].tolist(), pids_arr[va].tolist()) for tr, va in splits
    ]


def main(arguments):
    parser = Parser(prog="adell segmentation train")
    parser.add_argument_by_key(ARG_KEYS + UNPORTED_KEYS)
    args = parser.parse_args(arguments)
    parser.reject_unported(args, UNPORTED_KEYS)
    if args.segmentation_net_type not in NET_TYPES:
        raise NotImplementedError(
            f"--segmentation_net_type {args.segmentation_net_type} is not "
            f"ported yet (the port has {', '.join(NET_TYPES)})"
        )
    device = use_device(args.dev)
    compute_dtype(args.precision)  # an unknown precision fails here

    data = Dataset(args.dataset_json, seed=args.seed)
    label_keys = list(args.mask_keys or [])
    data.apply_filters(
        presence_keys=list(args.image_keys) + label_keys,
        filter_on_keys=args.filter_on_keys,
        filter_is_optional=args.filter_is_optional,
    )
    if args.excluded_ids:
        data.subsample_dataset(excluded_key_list=args.excluded_ids)
    if args.subsample_size:
        data.subsample_dataset(subsample_size=args.subsample_size)
    if len(data) == 0:
        raise ValueError("no samples left after filtering")
    pids = list(data.keys())

    # --possible_labels sets the class count (binary up to two labels)
    n_classes = args.n_classes
    if args.possible_labels:
        n = len(args.possible_labels)
        n_classes = 2 if n <= 2 else n
    config, loss_fn = parse_config_unet(
        args.config_file, n_keys=len(args.image_keys),
        n_classes=n_classes,
        loss_param_overrides={"gamma": args.loss_gamma, "lam": args.loss_comb},
    )
    net_cfg = config["network"]
    train_cfg = config["training"]
    batch_size = args.batch_size or train_cfg.get("batch_size", 2)
    learning_rate = args.learning_rate or train_cfg.get("learning_rate", 1e-3)
    weight_decay = train_cfg.get("weight_decay", 0.0)
    if args.dropout_param:
        net_cfg["dropout_param"] = args.dropout_param
    net_cfg["bottleneck_classification"] = args.bottleneck_classification
    net_cfg["deep_supervision"] = args.deep_supervision
    if args.res_config_file:
        if args.segmentation_net_type != "unet":
            raise NotImplementedError(
                "--res_config_file applies to the unet net type")
        net_cfg.update(resnet_encoder_config(load_yaml(args.res_config_file)))
    if args.encoder_checkpoint and "encoder_structure" not in net_cfg:
        raise ValueError(
            "--encoder_checkpoint needs a ResNet encoder: pass "
            "--res_config_file (or encoder_structure in the network yaml)")

    target_spacing = args.target_spacing
    if target_spacing is None:
        spacings = spacing_values_from_dataset_json(
            data.dataset, args.image_keys[0], n=32
        )
        if spacings:
            target_spacing = get_spacing_quantile(spacings)
            logger.info("inferred target spacing: %s", target_spacing)

    base_size = args.pad_size or args.resize_size or args.crop_size
    if base_size is None:
        raise ValueError(
            "one of --pad_size/--resize_size/--crop_size is required")
    crop_size = args.random_crop_size or args.crop_size
    if ("unetr" in args.segmentation_net_type and crop_size
            and tuple(crop_size) != tuple(base_size)):
        # UNETR's positional embedding fixes its input size, and predict,
        # test and whole-volume validation run it at --pad_size
        raise NotImplementedError(
            "random crops smaller than the volume are ported for the unet "
            "and swin net types only"
        )
    if int(net_cfg.get("spatial_dimensions", 3)) != 3:
        raise NotImplementedError("2D networks are not ported yet")

    folds = get_folds(pids, args.n_folds, args.seed, args.folds,
                      val_fraction=args.val_from_train)
    metric_logger = metric_logger_of(args)
    positive_labels = [int(x) for x in (args.positive_labels or [1])]
    mode = "min" if "loss" in args.monitor else "max"

    for fold_idx, (train_pids, val_pids) in enumerate(folds):
        train_pids = filter_training_pids(
            train_pids,
            excluded=args.excluded_ids_from_training_data,
            subsample_fraction=args.subsample_training_data,
            seed=args.seed,
            fold_idx=fold_idx,
        )
        logger.info(
            "fold %d: %d train / %d val", fold_idx, len(train_pids),
            len(val_pids),
        )
        transforms = SegmentationTransforms(
            image_keys=args.image_keys,
            label_keys=label_keys,
            target_spacing=target_spacing,
            target_size=base_size,
            resize_size=args.resize_size,
            adc_keys=args.adc_keys or (),
            positive_labels=positive_labels,
            crop_size=(crop_size if crop_size and list(crop_size)
                       != list(base_size) else None),
            # segmentation training: rotation-only affine, flips on all
            # three axes (the reference's seg factory)
            augmentations=AugmentPolicy.from_flags(
                args.augment, scale_range=0.0, flip_axes=(0, 1, 2)
            ),
            seed=args.seed + fold_idx,
        )
        load_fn = transforms.load_fn()
        train_list = data.to_datalist(train_pids)
        cache = dict(cache_rate=args.cache_rate, cache_dir=args.cache_dir,
                     cache_fingerprint=repr(transforms))
        train_ds = CachedVolumeDataset(train_list, load_fn, **cache)
        val_ds = CachedVolumeDataset(data.to_datalist(val_pids), load_fn,
                                     **cache)
        if args.constant_ratio is not None:
            # the class of an entry whose mask is a path (as in every
            # dataset file) is 1, as in the JAX package: every case is kept
            labels = [
                int(any(np.asarray(e.get(k, 0)).max() > 0
                        for k in label_keys))
                if not isinstance(e.get(label_keys[0], None), str) else 1
                for e in train_list
            ]
            sampler = PartiallyRandomSampler(
                labels, non_keep_ratio=args.constant_ratio, seed=args.seed)
        else:
            sampler = RandomSampler(len(train_ds), seed=args.seed)
        if args.samples_per_epoch is not None:
            sampler.set_n_samples(args.samples_per_epoch)
        elif (args.dataset_iterations_per_epoch or 1.0) != 1.0:
            sampler.set_n_samples(max(
                1, int(len(train_ds) * args.dataset_iterations_per_epoch)
            ))
        train_loader = DataLoader(
            train_ds, sampler=sampler, batch_size=batch_size,
            drop_last=True, prefetch=max(args.n_workers, 2),
        )
        val_sampler, val_len = None, len(val_ds)
        if args.validation_samples_per_epoch is not None:
            val_len = args.validation_samples_per_epoch
            val_sampler = RandomSampler(len(val_ds), seed=args.seed + 7,
                                        n_samples=val_len)
        val_loader = DataLoader(
            val_ds, sampler=val_sampler,
            batch_size=max(1, min(batch_size, val_len)),
            drop_last=True, prefetch=1,
        )

        torch.manual_seed(args.seed)
        model = get_segmentation_network(
            args.segmentation_net_type, net_cfg, n_classes=n_classes,
            image_size=base_size,
        ).to(device)
        seed_dropout(
            model,
            torch.Generator(device=device).manual_seed(args.seed + fold_idx),
        )
        for ck_path in args.checkpoint or []:
            warm_start(model, ck_path, args.exclude_from_state_dict)
        for ck_path in args.encoder_checkpoint or []:
            subtree_warm_start(model, ck_path, "encoder_backbone",
                               ENCODER_SOURCES)

        steps_per_epoch = max(len(train_loader), 1)
        if args.steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
        # the schedule advances once per optimizer step, every
        # --accumulate_grad_batches steps
        sched_steps = max(
            1, steps_per_epoch // max(1, args.accumulate_grad_batches))
        schedule = cosine_annealing_with_warmup(
            learning_rate,
            t_max=args.max_epochs * sched_steps,
            n_warmup_steps=args.warmup_steps * sched_steps
            if args.warmup_steps >= 1 else args.warmup_steps,
            start_decay=args.start_decay,
        )

        def make_tx(params):
            tx = get_optimizer(
                args.optimizer, learning_rate=schedule,
                weight_decay=weight_decay, clip_norm=args.gradient_clip_val,
                params=params,
            )
            if args.lr_encoder is not None and learning_rate > 0:
                tx = lr_scale_by_regex(tx, params, {
                    ENCODER_REGEX: args.lr_encoder / learning_rate})
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
            name=args.checkpoint_name or "segmentation",
            fold=fold_idx,
            monitor=args.monitor,
            mode=mode,
            metadata={
                "network_config": net_cfg,
                "transform_arguments": {
                    "image_keys": list(args.image_keys),
                    "skip_keys": [],
                    "feature_keys": [],
                    "label_keys": label_keys,
                    "target_spacing": target_spacing,
                    "target_size": list(base_size),
                    "resize_size": (list(args.resize_size)
                                    if args.resize_size else None),
                    "crop_size": list(crop_size) if crop_size else None,
                    "adc_keys": list(args.adc_keys or ()),
                    "positive_labels": positive_labels,
                },
                "train_pids": train_pids,
                "val_pids": val_pids,
                "n_classes": n_classes,
                "net_type": args.segmentation_net_type,
            },
        )
        ckpt.begin_run(resume=args.resume_from_last)
        if (args.resume_from_last
                and ckpt.status(args.max_epochs) == "finished"):
            logger.info("fold %d already finished; skipping", fold_idx)
            continue
        step_kwargs = dict(n_classes=n_classes, precision=args.precision)
        train_step = make_train_step(make_segmentation_step(
            model, loss_fn, train=True, **step_kwargs
        ))
        if args.sliding_window_val and transforms.crop_size is not None:
            eval_step = make_sliding_window_eval_step(
                model, loss_fn, crop_size, **step_kwargs
            )
        else:
            eval_step = make_eval_step(make_segmentation_step(
                model, loss_fn, train=False, **step_kwargs
            ))
        callbacks = []
        if args.picai_eval:
            callbacks.append(LesionEvalCallback(
                lambda params, x: whole_volume_forward(model, params, x)
            ))
        loop = TrainLoop(
            train_step=train_step,
            eval_step=eval_step,
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
            callbacks=callbacks,
            nan_guard=(NaNGuard(dump_dir=args.checkpoint_dir or ".")
                       if args.check_nan_loss else None),
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
        if args.cache_dir is not None:
            logger.info(
                "fold %d: disk cache %d read, %d written", fold_idx,
                train_ds.disk_reads + val_ds.disk_reads,
                train_ds.disk_writes + val_ds.disk_writes,
            )
        final = history[-1] if history else {}
        metric_logger.log_metrics(
            final, step=args.max_epochs, fold=fold_idx, phase="final"
        )
        if args.log_model:
            metric_logger.log_artifact(ckpt.dir)
        logger.info("fold %d done: %s", fold_idx,
                    json.dumps(final, default=float))


def whole_volume_forward(model, params, x):
    """The f32 probabilities of ``x`` [B, *S, C] through ``model`` with
    ``params``, in eval mode and without its heads (the lesion callback's
    forward)."""
    model.eval()
    return torch.func.functional_call(model, params, (x,), {"heads": False})
