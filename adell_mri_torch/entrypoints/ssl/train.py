"""
``python -m adell_mri_torch ssl train`` (or ``train_3d``).

Counterpart of ``adell_mri_tpu/entrypoints/ssl/train.py``: dataset JSON
-> config (``parse_config_ssl``) -> ``SSLTransforms`` (two views a
sample) -> cached dataset -> ``RandomSampler`` batches with
``drop_last`` -> network (``get_ssl_network``) -> AdamW (``--optimizer``
where it is not the default ``sgd``) with the norms and biases excluded
from a decay of at least 1e-6, under cosine annealing with warmup -> an
EMA teacher for ``byol`` and ``ijepa`` or with ``--ema`` (decay
``--ema_decay``, 0.996 by default, ramped to 1 over the run) ->
``TrainLoop``. The checkpoint directory ``{name}_fold0`` (name
``ssl_{method}`` by default) holds ``metadata.json`` with
``network_config``, ``ssl_method`` and ``transform_arguments``, the
latest epoch's weights (no validation: nothing is monitored) and the last
state for ``--resume_from_last``. DINO's centre and iBOT's two centres
(zeros of the config's ``out_dim``, 4096 by default, at the start) ride
in the state's variables, so both files keep them and a resume restores
them.

Ported: the two-view methods (``vicreg``, ``barlow_twins``, ``simclr``,
``simsiam``, ``byol``; ``--stop_gradient``) and ``vicregl`` (views with
their crop matrices) on a conv backbone, ``dino`` (EMA teacher;
``--n_local_crops`` local crops a sample), ``ibot`` (EMA teacher; block
masks drawn from a generator seeded with ``--seed`` + 1), ``mae`` (its
masking noise from that generator) and ``ijepa``, in bf16 or f32, on 3D
volumes. MAE and I-JEPA read the base-size image, unaugmented, as the
JAX steps do, so the port draws no views for them. Refused with
``NotImplementedError``: 2D backbones (``train_2d``), ``--sample_channels``,
and ``ijepa`` with a ``--random_crop_size`` other than the base size (the
JAX CLI builds the network at the crop size and steps it at the base
size, so its first step fails on the positional embedding's shape; ROADMAP
Queue 3). ``--logger_type``, ``--project_name`` and ``--summary_name``
go to ``MetricLogger`` as the JAX CLI passes them: the CSV always, wandb
or MLflow where installed.
"""

import json
import logging

import torch

from adell_mri_torch.config.factories import get_ssl_network
from adell_mri_torch.config.parsing import parse_config_ssl
from adell_mri_torch.data.dataset import Dataset
from adell_mri_torch.data.loader import CachedVolumeDataset, DataLoader
from adell_mri_torch.data.samplers import RandomSampler
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.logging_utils import metric_logger_of
from adell_mri_torch.train.loop import TrainLoop
from adell_mri_torch.train.optim import get_optimizer
from adell_mri_torch.train.precision import compute_dtype
from adell_mri_torch.train.schedules import cosine_annealing_with_warmup
from adell_mri_torch.train.ssl_steps import (
    EMA_METHODS,
    IMAGE_METHODS,
    initial_centres,
    make_method_step,
    make_ssl_train_step,
)
from adell_mri_torch.train.state import TrainState
from adell_mri_torch.transforms.pipeline import SSLTransforms

logger = logging.getLogger(__name__)

ARG_KEYS = [
    "dataset_json",
    "image_keys",
    "adc_keys",
    "filter_on_keys",
    "cache_rate",
    "cache_dir",
    "subsample_size",
    "target_spacing",
    "pad_size",
    "crop_size",
    "random_crop_size",
    "config_file",
    "dev",
    "precision",
    "n_workers",
    "seed",
    "max_epochs",
    "warmup_steps",
    "dropout_param",
    "batch_size",
    "learning_rate",
    "optimizer",
    "gradient_clip_val",
    "checkpoint_dir",
    "checkpoint_name",
    "resume_from_last",
    "monitor",
    "metric_path",
    "ssl_method",
    "ema",
    "ema_decay",
    "stop_gradient",
    "n_local_crops",
    "sample_channels",
    "logger_type",
    "project_name",
    "summary_name",
]


def main(arguments):
    parser = Parser(prog="adell ssl train")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    method = args.ssl_method
    device = use_device(args.dev)
    compute_dtype(args.precision)  # an unknown precision fails here

    config = parse_config_ssl(
        args.config_file, dropout_param=args.dropout_param,
        n_keys=len(args.image_keys), is_ijepa=method == "ijepa")
    net_cfg, train_cfg = config["network"], config["training"]
    batch_size = args.batch_size or train_cfg.get("batch_size", 4)
    learning_rate = args.learning_rate or train_cfg.get("learning_rate", 1e-3)
    weight_decay = train_cfg.get("weight_decay", 0.0)

    base_size = args.pad_size or args.crop_size
    crop_size = args.random_crop_size
    if base_size is None:
        raise ValueError("--pad_size or --crop_size required")
    sd = int((net_cfg.get("backbone_args") or {}).get(
        "spatial_dim", net_cfg.get("spatial_dim", 3)))
    if sd == 2 or len(base_size) == 2:
        raise NotImplementedError(
            "2D SSL (ssl train_2d) is not ported yet (ROADMAP Queue 1, item "
            "4)")
    if method == "ijepa" and crop_size and list(crop_size) != list(
            base_size):
        raise NotImplementedError(
            "ssl train --ssl_method ijepa with a --random_crop_size other "
            "than the base size: the JAX CLI builds I-JEPA at the crop size "
            "and steps it on the base-size image, so its first step fails "
            "on the positional embedding's shape (ROADMAP Queue 3); train "
            "I-JEPA without --random_crop_size")

    data = Dataset(args.dataset_json, seed=args.seed)
    data.apply_filters(presence_keys=list(args.image_keys),
                       filter_on_keys=args.filter_on_keys)
    if args.subsample_size:
        data.subsample_dataset(subsample_size=args.subsample_size)

    transforms = SSLTransforms(
        image_keys=args.image_keys,
        target_spacing=args.target_spacing,
        target_size=base_size,
        crop_size=crop_size,
        adc_keys=args.adc_keys or (),
        sample_channels=args.sample_channels,
        # VICRegL matches local features by their position in the volume
        expose_boxes=method == "vicregl",
        n_local_crops=args.n_local_crops if method == "dino" else 0,
        seed=args.seed,
    )
    ds = CachedVolumeDataset(
        data.to_datalist(), transforms.load_fn(),
        cache_rate=args.cache_rate, cache_dir=args.cache_dir,
        cache_fingerprint=repr(transforms),
    )
    loader = DataLoader(
        ds, sampler=RandomSampler(len(ds), seed=args.seed),
        batch_size=batch_size, drop_last=True,
        prefetch=max(args.n_workers, 2),
    )

    torch.manual_seed(args.seed)
    shape = tuple(crop_size or base_size)
    model = get_ssl_network(method, net_cfg,
                            in_channels=len(args.image_keys),
                            image_size=shape).to(device)
    steps_per_epoch = max(len(loader), 1)
    n_steps = args.max_epochs * steps_per_epoch
    schedule = cosine_annealing_with_warmup(
        learning_rate, t_max=n_steps, n_warmup_steps=args.warmup_steps)
    use_ema = args.ema or method in EMA_METHODS
    state = TrainState.create(
        model,
        lambda params: get_optimizer(
            args.optimizer if args.optimizer != "sgd" else "adamw",
            learning_rate=schedule,
            weight_decay=weight_decay or 1e-6,
            clip_norm=args.gradient_clip_val,
            params=params,
            exclude_norms_from_decay=True,
            model=model,
        ),
        with_ema=use_ema,
        ema_decay=args.ema_decay if args.ema_decay is not None else 0.996,
        ema_final_decay=1.0,
        ema_n_steps=n_steps,
    )
    state.variables.update(initial_centres(
        method, net_cfg.get("out_dim", 4096), device))
    lm = make_method_step(
        model, method, precision=args.precision,
        generator=torch.Generator(device=device).manual_seed(args.seed + 1),
        ema_teacher=use_ema, stop_gradient=bool(args.stop_gradient))
    ckpt = CheckpointManager(
        args.checkpoint_dir,
        name=args.checkpoint_name or f"ssl_{method}",
        fold=0,
        metadata={
            "network_config": net_cfg,
            "ssl_method": method,
            "transform_arguments": {
                "image_keys": list(args.image_keys),
                "sample_channels": args.sample_channels,
                "target_size": list(base_size),
                "crop_size": list(crop_size) if crop_size else None,
                "target_spacing": (list(args.target_spacing)
                                   if args.target_spacing else None),
            },
        },
        monitor=args.monitor,
    )
    ckpt.begin_run(resume=bool(args.resume_from_last))
    if (args.resume_from_last
            and ckpt.status(args.max_epochs) == "finished"):
        logger.info("checkpoint already finished; nothing to do")
        return
    loop = TrainLoop(
        train_step=make_ssl_train_step(lm),
        augment_fn=None if method in IMAGE_METHODS else transforms.augment,
        device=device,
        max_epochs=args.max_epochs,
        ckpt_manager=ckpt,
        metric_logger=metric_logger_of(args),
        monitor=args.monitor,
        seed=args.seed,
    )
    start_epoch = 0
    if args.resume_from_last:
        state, start_epoch = ckpt.resume(state)
        if start_epoch:
            logger.info("resuming from epoch %d", start_epoch)
    state, history = loop.fit(state, loader, start_epoch=start_epoch)
    logger.info("done: %s",
                json.dumps(history[-1] if history else {}, default=float))
