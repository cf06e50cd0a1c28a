"""
``python -m adell_mri_torch classification_ensemble train``.

Counterpart of ``adell_mri_tpu/entrypoints/classification_ensemble/
train.py``: a ``GenericEnsemble`` over one member network a
``--config_files`` entry (``--classification_net_type``, each built with
``feature_extraction``; the last config's ``batch_size`` and
``learning_rate`` unless the flags give them), concatenated features
into a ``(64,)`` relu head, trained on fold 0 of ``--n_folds`` (the
images at ``--pad_size``, no augmentation) with AdamW under cosine
annealing with warmup, f32. As in the JAX CLI the train state carries
no running statistics: every step, in training and in validation,
applies the parameters alone (the batch norms normalise by each batch,
``parameters_alone``), and the checkpoint keeps the initial (0, 1) that
``test`` and ``predict``, applying the parameters alone as well, never
read. ``metadata.json`` holds ``member_configs`` (each member's network
config), ``n_members``, ``n_classes``, ``net_type`` and the transform
arguments. Members whose JAX modules take no ``return_features``
(``ord``, ``unet``, ``vit``, ``factorized_vit``: the JAX ensemble stops
at its first call) are refused with a ValueError.
"""

import json
import logging

import torch

from adell_mri_torch.config.factories import get_classification_network
from adell_mri_torch.config.parsing import parse_config_cat
from adell_mri_torch.data.dataset import Dataset
from adell_mri_torch.data.loader import CachedVolumeDataset, DataLoader
from adell_mri_torch.data.samplers import RandomSampler
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification.predict import NO_FEATURES
from adell_mri_torch.entrypoints.classification.train import (
    parameters_alone,
)
from adell_mri_torch.entrypoints.cli_utils import (
    derive_n_classes,
    parse_label_groups,
    stratification_labels,
)
from adell_mri_torch.entrypoints.segmentation.train import get_folds
from adell_mri_torch.models.classification.losses import (
    binary_logistic_loss,
    cross_entropy_loss,
)
from adell_mri_torch.models.classification.nets import GenericEnsemble
from adell_mri_torch.models.layers.dropout import seed_dropout
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.logging_utils import MetricLogger
from adell_mri_torch.train.loop import TrainLoop
from adell_mri_torch.train.optim import get_optimizer
from adell_mri_torch.train.schedules import cosine_annealing_with_warmup
from adell_mri_torch.train.state import TrainState
from adell_mri_torch.train.steps import (
    make_classification_step,
    make_eval_step,
    make_train_step,
)
from adell_mri_torch.transforms.pipeline import ClassificationTransforms

logger = logging.getLogger(__name__)

ARG_KEYS = [
    "dataset_json",
    "image_keys",
    ("label_keys", "label_keys", dict(nargs=None, default="label")),
    "possible_labels",
    "positive_labels",
    "label_groups",
    "config_files",
    "cache_rate",
    "cache_dir",
    "n_folds",
    "target_spacing",
    "pad_size",
    "dev",
    "seed",
    "max_epochs",
    "warmup_steps",
    "n_classes",
    "batch_size",
    "learning_rate",
    "checkpoint_dir",
    "checkpoint_name",
    "monitor",
    "metric_path",
    "classification_net_type",
]


def ensemble_network(net_type: str, member_configs, n_classes: int,
                     in_channels: int = 1) -> GenericEnsemble:
    """The ``GenericEnsemble`` of one headless ``net_type`` network a
    config."""
    if net_type in NO_FEATURES:
        raise ValueError(
            f"net_type {net_type!r} cannot be an ensemble member: "
            f"{NO_FEATURES[net_type]} takes no return_features")
    members = [
        get_classification_network(net_type, cfg, n_classes=n_classes,
                                   in_channels=in_channels,
                                   feature_extraction=True)
        for cfg in member_configs
    ]
    return GenericEnsemble(members, n_classes=n_classes)


def main(arguments):
    parser = Parser(prog="adell classification_ensemble train")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    device = use_device(args.dev)
    label_key = args.label_keys
    n_classes = derive_n_classes(args)
    label_groups = parse_label_groups(args.label_groups)

    data = Dataset(args.dataset_json, seed=args.seed)
    data.apply_filters(presence_keys=list(args.image_keys) + [label_key])
    member_cfgs = []
    batch_size, lr = 4, 1e-3
    for cf in args.config_files or []:
        config = parse_config_cat(cf)
        member_cfgs.append(config["network"])
        batch_size = args.batch_size or config["training"].get(
            "batch_size", 4)
        lr = args.learning_rate or config["training"].get(
            "learning_rate", 1e-3)
    if not member_cfgs:
        raise ValueError("--config_files required (one per ensemble member)")
    torch.manual_seed(args.seed)
    model = ensemble_network(args.classification_net_type, member_cfgs,
                             n_classes, len(args.image_keys)).to(device)
    seed_dropout(model, torch.Generator(device=device).manual_seed(args.seed))

    base_size = tuple(args.pad_size)
    labels_args = dict(
        positive_labels=(list(args.positive_labels)
                         if args.positive_labels and n_classes == 2
                         and args.possible_labels else None),
        possible_labels=(list(args.possible_labels)
                         if args.possible_labels and not args.positive_labels
                         else None),
        label_groups=label_groups,
    )
    transforms = ClassificationTransforms(
        image_keys=args.image_keys, label_key=label_key,
        target_spacing=args.target_spacing, target_size=base_size,
        **labels_args)
    pids = list(data.keys())
    train_pids, val_pids = get_folds(
        pids, args.n_folds, args.seed,
        labels=stratification_labels(data, pids, label_key, args.n_folds,
                                     None))[0]
    load_fn = transforms.load_fn()
    cache = dict(cache_rate=args.cache_rate, cache_dir=args.cache_dir,
                 cache_fingerprint=repr(transforms))
    train_ds = CachedVolumeDataset(data.to_datalist(train_pids), load_fn,
                                   **cache)
    val_ds = CachedVolumeDataset(data.to_datalist(val_pids), load_fn,
                                 **cache)
    train_loader = DataLoader(
        train_ds, sampler=RandomSampler(len(train_ds), seed=args.seed),
        batch_size=batch_size, drop_last=True)
    val_loader = DataLoader(
        val_ds, batch_size=max(1, min(batch_size, len(val_ds))),
        drop_last=True)

    schedule = cosine_annealing_with_warmup(
        lr, t_max=args.max_epochs * max(len(train_loader), 1),
        n_warmup_steps=args.warmup_steps)
    state = TrainState.create(
        model, lambda params: get_optimizer("adamw", learning_rate=schedule,
                                            params=params))
    loss_fn = cross_entropy_loss if n_classes > 2 else binary_logistic_loss
    ckpt = CheckpointManager(
        args.checkpoint_dir, name=args.checkpoint_name or "ensemble", fold=0,
        metadata={
            "n_members": len(member_cfgs),
            "n_classes": n_classes,
            "net_type": args.classification_net_type,
            "member_configs": member_cfgs,
            "transform_arguments": {
                "image_keys": list(args.image_keys),
                "label_key": label_key,
                "target_spacing": args.target_spacing,
                "target_size": list(base_size),
                **labels_args,
            },
        },
        monitor=args.monitor,
    )
    ckpt.begin_run(resume=False)
    loop = TrainLoop(
        train_step=make_train_step(parameters_alone(
            make_classification_step(model, loss_fn, n_classes, True),
            model, train=True)),
        eval_step=make_eval_step(parameters_alone(
            make_classification_step(model, loss_fn, n_classes, False),
            model, train=False)),
        device=device,
        max_epochs=args.max_epochs,
        ckpt_manager=ckpt,
        metric_logger=MetricLogger(csv_path=args.metric_path),
        monitor=args.monitor,
        seed=args.seed,
    )
    state, history = loop.fit(state, train_loader, val_loader)
    logger.info("done: %s", json.dumps(history[-1] if history else {},
                                       default=float))
