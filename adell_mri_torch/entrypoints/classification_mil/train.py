"""
``python -m adell_mri_torch classification_mil train``.

Counterpart of ``adell_mri_tpu/entrypoints/classification_mil/train.py``:
a 2D slice encoder (``SliceEncoder``: a headless 2D VGG with instance
norm, ``first_depth`` 16 and ``n_blocks`` 3 unless the yaml says
otherwise) trained jointly with a MIL head over the slices of each
volume: ``--mil_method standard`` (``MultipleInstanceClassifier``,
``attention_dim`` 64) or ``transformer`` (``TransformableTransformer``,
``embed_dim`` 64, ``transformer_blocks`` 2, ``n_heads`` 4), built by
``build_mil_model`` from the yaml's keys (``parse_config_2d_classifier_3d``;
``sample_configs/transformable-transformer.yaml``'s other keys reach no
module, as in the JAX CLI). One split (the first of ``--n_folds``,
stratified by the label), no augmentation, f32 steps, sgd/adam/adamw
under cosine annealing with warmup. ``--module_paths`` warm-starts the
slice encoder (the ``module`` subtree, or the whole tree, of each run's
best weights) and ``--freeze_module`` freezes it (``freeze_wrap`` on
``^module``). ``metadata.json`` keeps ``mil_method``, the network keys
and the transform arguments, from which ``test`` and ``predict`` rebuild
the model.
"""

import json
import logging

import torch
import torch.nn as nn

from adell_mri_torch.config.parsing import parse_config_2d_classifier_3d
from adell_mri_torch.data.dataset import Dataset
from adell_mri_torch.data.loader import CachedVolumeDataset, DataLoader
from adell_mri_torch.data.samplers import RandomSampler
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification.train import label_arguments
from adell_mri_torch.entrypoints.cli_utils import (
    derive_n_classes,
    stratification_labels,
)
from adell_mri_torch.entrypoints.segmentation.train import get_folds
from adell_mri_torch.models.classification.losses import (
    binary_logistic_loss,
    cross_entropy_loss,
)
from adell_mri_torch.models.classification.mil import (
    MultipleInstanceClassifier,
    TransformableTransformer,
)
from adell_mri_torch.models.classification.nets import VGG
from adell_mri_torch.train.checkpoints import (
    CheckpointManager,
    freeze_mask_by_regex,
    subtree_warm_start,
)
from adell_mri_torch.train.logging_utils import MetricLogger
from adell_mri_torch.train.loop import TrainLoop
from adell_mri_torch.train.optim import freeze_wrap, get_optimizer
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
    "optimizer",
    "checkpoint_dir",
    "checkpoint_name",
    "monitor",
    "metric_path",
]
MIL_METHODS = ("standard", "transformer")


class SliceEncoder(nn.Module):
    """The JAX CLI's ``_SliceEncoder``: a headless 2D VGG (``VGG_0``,
    instance norm) giving each slice ``[b, H, W, C]`` its pooled
    features ``[b, n_features]``."""

    def __init__(self, in_channels: int = 1, first_depth: int = 16,
                 n_blocks: int = 3):
        super().__init__()
        self.VGG_0 = VGG(in_channels, first_depth=first_depth,
                         n_blocks=n_blocks, norm_type="instance",
                         feature_extraction=True, ndim=2)
        self.n_features = self.VGG_0.n_features

    def forward(self, x):
        return self.VGG_0(x)


def build_mil_model(net_cfg, mil_method: str, n_classes: int,
                    in_channels: int = 1) -> nn.Module:
    """The MIL model of ``mil_method`` from the network keys (train, test
    and predict build the same tree from the checkpoint's metadata)."""
    if mil_method not in MIL_METHODS:
        raise ValueError(f"mil_method {mil_method!r}: one of {MIL_METHODS}")
    encoder = SliceEncoder(in_channels,
                           first_depth=net_cfg.get("first_depth", 16),
                           n_blocks=net_cfg.get("n_blocks", 3))
    if mil_method == "transformer":
        return TransformableTransformer(
            encoder, encoder.n_features, n_classes=n_classes,
            embed_dim=net_cfg.get("embed_dim", 64),
            n_blocks=net_cfg.get("transformer_blocks", 2),
            n_heads=net_cfg.get("n_heads", 4))
    return MultipleInstanceClassifier(
        encoder, encoder.n_features, n_classes=n_classes,
        attention_dim=net_cfg.get("attention_dim", 64))


def main(arguments):
    parser = Parser(prog="adell classification_mil train")
    parser.add_argument_by_key(ARG_KEYS)
    parser.add_argument("--mil_method", default="standard",
                        choices=list(MIL_METHODS))
    parser.add_argument("--module_paths", nargs="+", default=None,
                        help="run directories to warm-start the slice "
                        "encoder ('module' subtree) from")
    parser.add_argument("--freeze_module", action="store_true",
                        help="freeze the slice encoder (train only the MIL "
                        "head)")
    args = parser.parse_args(arguments)
    device = use_device(args.dev)

    data = Dataset(args.dataset_json, seed=args.seed)
    label_key = args.label_keys
    data.apply_filters(
        presence_keys=list(args.image_keys) + [label_key],
        possible_labels=args.possible_labels,
        label_keys=label_key if args.possible_labels else None,
    )
    config = (parse_config_2d_classifier_3d(args.config_file,
                                            mil_method=args.mil_method)
              if args.config_file else {"network": {}, "training": {}})
    net_cfg, train_cfg = config["network"], config["training"]
    batch_size = args.batch_size or train_cfg.get("batch_size", 4)
    lr = args.learning_rate or train_cfg.get("learning_rate", 1e-3)
    base_size = tuple(args.pad_size)
    n_classes = derive_n_classes(args)
    labels_args = label_arguments(args, n_classes)

    transforms = ClassificationTransforms(
        image_keys=args.image_keys,
        label_key=label_key,
        target_spacing=args.target_spacing,
        target_size=base_size,
        **labels_args,
    )
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

    torch.manual_seed(args.seed)
    model = build_mil_model(net_cfg, args.mil_method, n_classes,
                            in_channels=len(args.image_keys)).to(device)
    for ck_path in args.module_paths or []:
        subtree_warm_start(model, ck_path, "module", ("module", ""),
                           required=False)
    schedule = cosine_annealing_with_warmup(
        lr, t_max=args.max_epochs * max(len(train_loader), 1),
        n_warmup_steps=args.warmup_steps)

    def make_tx(params):
        tx = get_optimizer(args.optimizer, learning_rate=schedule,
                           params=params)
        if args.freeze_module:
            tx = freeze_wrap(tx, freeze_mask_by_regex(params, [r"^module"]))
        return tx

    state = TrainState.create(model, make_tx)
    loss_fn = cross_entropy_loss if n_classes > 2 else binary_logistic_loss
    ckpt = CheckpointManager(
        args.checkpoint_dir, name=args.checkpoint_name or "mil", fold=0,
        monitor=args.monitor,
        metadata={
            "network_config": net_cfg,
            "mil_method": args.mil_method,
            "transform_arguments": {
                "image_keys": list(args.image_keys),
                "label_key": label_key,
                "target_size": list(base_size),
                "target_spacing": (list(args.target_spacing)
                                   if args.target_spacing else None),
                **labels_args,
            },
            "n_classes": n_classes,
        },
    )
    ckpt.begin_run(resume=False)
    loop = TrainLoop(
        train_step=make_train_step(
            make_classification_step(model, loss_fn, n_classes, True)),
        eval_step=make_eval_step(
            make_classification_step(model, loss_fn, n_classes, False)),
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
