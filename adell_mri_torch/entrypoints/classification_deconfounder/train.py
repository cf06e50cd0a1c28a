"""
``python -m adell_mri_torch classification_deconfounder train``.

Counterpart of ``adell_mri_tpu/entrypoints/classification_deconfounder/
train.py``: a ``DeconfoundedNet`` over a headless CatNet
(``build_deconfounder_model``: the config's ``spatial_dimensions``,
``resnet_structure`` and ``norm_type``, instance norm by default, and
nothing else of it) trained on fold 0 of ``--n_folds`` (the images at
``--pad_size``, no augmentation) with AdamW under cosine annealing with
warmup, f32. The categorical confounders (``--cat_confounder_keys``) are
indexed by their sorted string values over the filtered dataset, whose
counts size the surrogate heads; the continuous ones
(``--cont_confounder_keys``) are read as floats. The loss
(``deconfounder_loss``) is the classification loss (the binary logistic
loss, softmax cross entropy above two classes), plus each categorical
surrogate's softmax cross entropy, plus the continuous surrogates' mean
squared error, plus ``--deconfounder_weight`` times the correlation
penalty. As in the JAX CLI the state carries no running statistics:
every step applies the parameters alone (batch norms, where the config
asks for them, normalise by each batch). ``metadata.json`` holds what
``test`` and ``predict`` rebuild from: ``network_config``, the
confounder keys, ``cat_confounder_cards``, ``n_classes``,
``n_features_deconfounder`` and the transform arguments. The CLI takes
the JAX CLI's flags and no others (no experiment loggers: the metric CSV
alone).
"""

import json
import logging
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from adell_mri_torch.config.parsing import parse_config_cat
from adell_mri_torch.data.dataset import Dataset
from adell_mri_torch.data.loader import CachedVolumeDataset, DataLoader
from adell_mri_torch.data.samplers import RandomSampler
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification.train import (
    label_arguments,
    parameters_alone,
)
from adell_mri_torch.entrypoints.cli_utils import (
    derive_n_classes,
    stratification_labels,
)
from adell_mri_torch.entrypoints.segmentation.train import get_folds
from adell_mri_torch.models.classification.deconfounded import (
    DeconfoundedNet,
)
from adell_mri_torch.models.classification.losses import (
    binary_logistic_loss,
    cross_entropy_loss,
)
from adell_mri_torch.models.classification.nets import CatNet
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.logging_utils import MetricLogger
from adell_mri_torch.train.loop import TrainLoop
from adell_mri_torch.train.optim import get_optimizer
from adell_mri_torch.train.schedules import cosine_annealing_with_warmup
from adell_mri_torch.train.state import TrainState
from adell_mri_torch.train.steps import (
    _forward_fn,
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
    "cache_rate",
    "cache_dir",
    "n_folds",
    "target_spacing",
    "pad_size",
    "config_file",
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
]


def build_deconfounder_model(net_cfg, cat_cards: Sequence[int], n_cont: int,
                             n_classes: int, n_features: int = 32,
                             in_channels: int = 1) -> DeconfoundedNet:
    """The ``DeconfoundedNet`` of a checkpoint's metadata (train, test and
    predict build the same tree): a headless CatNet of the config's
    ``spatial_dimensions``, ``resnet_structure`` and ``norm_type``."""
    backbone = CatNet(
        in_channels=in_channels,
        spatial_dimensions=net_cfg.get("spatial_dimensions", 3),
        resnet_structure=[tuple(s) for s in net_cfg.get(
            "resnet_structure", [(16, 16, 3, 1)])],
        norm_type=net_cfg.get("norm_type", "instance"),
        feature_extraction=True,
    )
    return DeconfoundedNet(backbone, n_classes=n_classes,
                           n_features_deconfounder=n_features,
                           n_cat_deconfounder=list(cat_cards),
                           n_cont_deconfounder=n_cont)


def deconfounder_loss(outputs, batch, n_classes: int, n_cat: int,
                      weight: float):
    """``(loss, penalty)`` of the model's four outputs on ``batch``
    (``label``, ``cat_conf_{i}``, ``cont_conf``)."""
    logits, cat_preds, cont_pred, penalty = outputs
    if n_classes > 2:
        loss = cross_entropy_loss(logits, batch["label"])
    else:
        loss = binary_logistic_loss(logits, batch["label"])
    for i in range(n_cat):
        loss = loss + F.cross_entropy(cat_preds[i],
                                      batch[f"cat_conf_{i}"].long())
    if cont_pred is not None:
        loss = loss + torch.mean((cont_pred - batch["cont_conf"]) ** 2)
    return loss + weight * penalty, penalty


def make_deconfounder_step(model: DeconfoundedNet, n_classes: int,
                           weight: float, train: bool = True,
                           precision: Optional[str] = None):
    """``loss_and_metrics(params, batch) -> (loss, metrics)`` with
    ``loss`` and ``decorrelation`` (the penalty) as the metrics."""
    forward = _forward_fn(model, precision)

    def loss_and_metrics(params, batch):
        model.train(train)
        outputs = forward(params, batch["image"])
        loss, penalty = deconfounder_loss(outputs, batch, n_classes,
                                          model.n_cat, weight)
        return loss, {"loss": loss, "decorrelation": penalty}

    return loss_and_metrics


def main(arguments):
    parser = Parser(prog="adell classification_deconfounder train")
    parser.add_argument_by_key(ARG_KEYS)
    parser.add_argument("--cat_confounder_keys", nargs="+", default=[])
    parser.add_argument("--cont_confounder_keys", nargs="+", default=[])
    parser.add_argument("--deconfounder_weight", type=float, default=1.0)
    parser.add_argument("--n_features_deconfounder", type=int, default=64,
                        help="width of the confound surrogate projection")
    args = parser.parse_args(arguments)
    device = use_device(args.dev)
    label_key = args.label_keys

    data = Dataset(args.dataset_json, seed=args.seed)
    data.apply_filters(presence_keys=list(args.image_keys) + [label_key]
                       + list(args.cat_confounder_keys)
                       + list(args.cont_confounder_keys))
    config = parse_config_cat(args.config_file)
    net_cfg, train_cfg = config["network"], config["training"]
    batch_size = args.batch_size or train_cfg.get("batch_size", 4)
    lr = args.learning_rate or train_cfg.get("learning_rate", 1e-3)
    base_size = tuple(args.pad_size)

    # the categorical confounders' values, indexed in sorted order
    cat_maps = []
    for key in args.cat_confounder_keys:
        values = sorted({str(data[k][key]) for k in data})
        cat_maps.append({v: i for i, v in enumerate(values)})
    cat_cards = [len(m) for m in cat_maps]
    n_classes = derive_n_classes(args)
    labels_args = label_arguments(args, n_classes)
    torch.manual_seed(args.seed)
    model = build_deconfounder_model(
        net_cfg, cat_cards, len(args.cont_confounder_keys), n_classes,
        n_features=args.n_features_deconfounder,
        in_channels=len(args.image_keys)).to(device)

    transforms = ClassificationTransforms(
        image_keys=args.image_keys, label_key=label_key,
        target_spacing=args.target_spacing, target_size=base_size,
        **labels_args)
    base_load = transforms.load_fn()

    def load_fn(entry):
        s = base_load(entry)
        for i, key in enumerate(args.cat_confounder_keys):
            s[f"cat_conf_{i}"] = np.int32(cat_maps[i][str(entry[key])])
        if args.cont_confounder_keys:
            s["cont_conf"] = np.asarray(
                [float(entry[k]) for k in args.cont_confounder_keys],
                np.float32)
        return s

    pids = list(data.keys())
    train_pids, val_pids = get_folds(
        pids, args.n_folds, args.seed,
        labels=stratification_labels(data, pids, label_key, args.n_folds,
                                     None))[0]
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
    ckpt = CheckpointManager(
        args.checkpoint_dir, name=args.checkpoint_name or "deconfounder",
        fold=0,
        metadata={
            "network_config": net_cfg,
            "cat_confounder_keys": list(args.cat_confounder_keys),
            "cont_confounder_keys": list(args.cont_confounder_keys),
            "cat_confounder_cards": cat_cards,
            "n_classes": n_classes,
            "n_features_deconfounder": args.n_features_deconfounder,
            "transform_arguments": {
                "image_keys": list(args.image_keys),
                "label_key": label_key,
                "target_size": list(base_size),
                "target_spacing": (list(args.target_spacing)
                                   if args.target_spacing else None),
                **labels_args,
            },
        },
        monitor=args.monitor,
    )
    ckpt.begin_run(resume=False)

    def step(train):
        return parameters_alone(make_deconfounder_step(
            model, n_classes, args.deconfounder_weight, train), model,
            train=train)

    loop = TrainLoop(
        train_step=make_train_step(step(True)),
        eval_step=make_eval_step(step(False)),
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
