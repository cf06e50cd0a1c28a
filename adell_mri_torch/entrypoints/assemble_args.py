"""
Declarative CLI argument registry, the keys the ported entry points use.

The port's own copy of ``Parser`` and of those entries of
``argument_factory`` from ``adell_mri_tpu/entrypoints/assemble_args.py``;
flag names and defaults match, except ``--dev``, which defaults to
``cuda``. ``--params_from``/``--overrides`` are not ported yet. The
entries under "parsed, not ported yet" exist so that an entry point can
refuse them by name (``reject_unported``).
"""

import argparse
from typing import Any, Dict, List

argument_factory: Dict[str, Dict[str, Any]] = {
    "dataset_json": dict(
        required=True, nargs="+", help="Path to dataset JSON/YAML file(s)"
    ),
    "image_keys": dict(
        required=True, nargs="+", help="Image keys in dataset JSON"
    ),
    "prediction_ids": dict(default=None, nargs="+", help="IDs to predict"),
    "checkpoint_dir": dict(default="ckpt", help="Checkpoint directory"),
    "checkpoint_name": dict(type=str, default=None, help="Checkpoint ID"),
    "checkpoint": dict(
        default=None, nargs="+", help="Checkpoint fold directories"
    ),
    "output_path": dict(default="output", help="Output path"),
    "sliding_window_size": dict(
        default=None, nargs="+", type=int, help="Sliding window size"
    ),
    "sliding_window_stride": dict(
        default=0.5, type=float,
        help="Sliding window stride: <= 1 is a window fraction (1.0 = no "
        "overlap), > 1 is absolute voxels",
    ),
    "flip_tta": dict(action="store_true", help="Flip test-time augmentation"),
    "mc_iterations": dict(
        default=None, type=int, help="MC dropout iterations"
    ),
    "dev": dict(default="cuda", type=str, help="Device (cuda[:N] or cpu)"),
    "n_classes": dict(type=int, default=2, help="Number of classes"),
    "prediction_type": dict(
        default="probability", help="probability (else a thresholded mask)"
    ),
    "exclude_surrogate_variables": dict(
        action="store_true",
        help="Excludes deconfounder surrogate predictions from the output",
    ),
    "segmentation_net_type": dict(
        default="unet",
        choices=["unet", "unetpp", "brunet", "unetr", "swin", "monai_unetr",
                 "monai_swin"],
        help="Segmentation architecture",
    ),
    "precision": dict(type=str, default="32", help="Precision: 32|bf16"),
    # training
    "mask_keys": dict(
        default=None, nargs="+", help="Mask keys in dataset JSON"
    ),
    "adc_keys": dict(
        default=None, nargs="+",
        help="Keys of ADC maps (conditionally rescaled)",
    ),
    "positive_labels": dict(
        default=None, nargs="+", help="Labels considered positive"
    ),
    "cache_rate": dict(
        default=1.0, type=float, help="Fraction of dataset cached in RAM"
    ),
    "val_from_train": dict(
        default=None, type=float, help="Fraction of train used for val"
    ),
    "n_folds": dict(default=5, type=int, help="Number of validation folds"),
    "target_spacing": dict(
        default=None, nargs="+", type=float, help="Target spacing"
    ),
    "pad_size": dict(default=None, nargs="+", type=int, help="Pad size"),
    "crop_size": dict(default=None, nargs="+", type=int, help="Crop size"),
    "random_crop_size": dict(
        default=None, nargs="+", type=int, help="Random crop size"
    ),
    "config_file": dict(required=True, help="Network YAML config"),
    "n_workers": dict(
        default=0, type=int, help="No. of workers (prefetch depth here)"
    ),
    "seed": dict(default=42, type=int, help="Random seed"),
    "max_epochs": dict(default=100, type=int, help="Maximum epochs"),
    "warmup_steps": dict(
        default=0.0, type=float, help="Warmup steps/epochs"
    ),
    "start_decay": dict(default=None, type=float, help="When decay starts"),
    "augment": dict(
        default=[], nargs="+",
        help="Augmentation flags (intensity noise rbf affine shear flip "
        "blur distort lowres trivial)",
    ),
    "dropout_param": dict(default=0.0, type=float, help="Dropout parameter"),
    "batch_size": dict(type=int, default=None, help="Batch size"),
    "learning_rate": dict(type=float, default=None, help="Learning rate"),
    "loss_gamma": dict(
        default=None, type=float, help="Focal gamma routed into losses"
    ),
    "loss_comb": dict(
        default=None, type=float,
        help="Hybrid/unified focal combination weight (lam)",
    ),
    "steps_per_epoch": dict(
        default=None, type=int, help="Cap on train batches per epoch"
    ),
    "dataset_iterations_per_epoch": dict(
        default=1.0, type=float,
        help="Number of dataset iterations per training epoch",
    ),
    "samples_per_epoch": dict(
        default=None, type=int,
        help="Training samples per epoch (drawn with replacement)",
    ),
    "optimizer": dict(default="sgd", type=str, help="Optimizer name"),
    "gradient_clip_val": dict(
        default=None, type=float, help="Gradient clipping value"
    ),
    "check_val_every_n_epoch": dict(
        default=1, type=int, help="Val frequency"
    ),
    "monitor": dict(default="val_loss", help="Metric to monitor"),
    "metric_path": dict(default="metrics.csv", help="CSV metrics output path"),
    "early_stopping": dict(
        default=None, type=int, help="Early stopping patience"
    ),
    "swa": dict(
        action="store_true",
        help="Stochastic weight averaging (equal-weight running average of "
        "params over the last quarter of training; validated on)",
    ),
    "check_nan_loss": dict(
        action="store_true",
        help="NaN-loss forensics: check loss finiteness each step and dump "
        "the in-flight batch to .npz before raising (costs a host sync)",
    ),
    "resume_from_last": dict(
        action="store_true", help="Resume from last checkpoint"
    ),
    "sliding_window_val": dict(
        action="store_true",
        help="Validate whole volumes with overlap-averaged sliding-window "
        "inference at the training crop size",
    ),
    "picai_eval": dict(action="store_true", help="Lesion-level PI-CAI eval"),
    "test_ids": dict(default=None, nargs="+", help="Test IDs"),
    "filter_on_keys": dict(
        default=[], nargs="+",
        help="Filter expressions (key=value, key!=value, key>value, "
        "key<value, key(in)a,b, key(match)s, key(!match)s)",
    ),
    "filter_is_optional": dict(
        action="store_true", help="Entries without a filtered key pass it"
    ),
    "possible_labels": dict(
        default=None, nargs="+",
        help="All possible labels (sets the class count)",
    ),
    "excluded_ids": dict(
        default=None, nargs="+", help="IDs excluded from the dataset"
    ),
    "excluded_ids_from_training_data": dict(
        default=None, nargs="+",
        help="IDs excluded from the training split only",
    ),
    "cache_dir": dict(
        default=None, help="Disk cache directory for preprocessed volumes"
    ),
    "subsample_size": dict(
        default=None, type=int, help="Subsample dataset size"
    ),
    "subsample_training_data": dict(
        default=None, type=float,
        help="Subsamples the training data by this fraction",
    ),
    "folds": dict(
        default=None, nargs="+",
        help="Explicit folds: each the validation IDs (a file or a "
        "comma-separated list)",
    ),
    "validation_samples_per_epoch": dict(
        default=None, type=int,
        help="Number of validation samples per epoch",
    ),
    "constant_ratio": dict(
        default=None, type=float,
        help="Share of the non-kept class sampled each epoch",
    ),
    # classification
    "label_keys": dict(
        default=None, nargs="+", help="Label keys in dataset JSON"
    ),
    "label_groups": dict(
        default=None, nargs="+", help="Label groups for classification"
    ),
    "label_smoothing": dict(default=None, type=float, help="Label smoothing"),
    "mixup_alpha": dict(default=None, type=float, help="Alpha for mixup"),
    "partial_mixup": dict(
        default=None, type=float, help="Fraction for partial mixup"
    ),
    "class_weights": dict(
        default=None, nargs="+", type=float, help="Class weights"
    ),
    "weighted_sampling": dict(
        action="store_true", help="Class-weighted sampling"
    ),
    "correct_classification_bias": dict(
        action="store_true", help="Set output bias to log-odds"
    ),
    "classification_net_type": dict(
        default="cat",
        choices=["cat", "ord", "vgg", "vit", "factorized_vit", "unet",
                 "resnet", "convnext", "convnext_backbone", "convnext_v2"],
        help="Classification architecture",
    ),
    # self-supervised learning
    "ssl_method": dict(
        default="vicreg",
        choices=["simsiam", "byol", "vicreg", "vicregl", "barlow_twins",
                 "simclr", "dino", "ibot", "mae", "ijepa"],
        help="SSL method",
    ),
    "ema": dict(action="store_true", help="EMA teacher"),
    "ema_decay": dict(
        default=None, type=float,
        help="EMA decay for teacher/shadow params (default: per-method)",
    ),
    "stop_gradient": dict(
        action="store_true", help="Stop gradient on target branch"
    ),
    "n_local_crops": dict(
        default=0, type=int,
        help="DINO multi-crop: number of extra small student views",
    ),
    "sample_channels": dict(
        default=None, type=int,
        help="Randomly keep this many channels of each 4D (multi-channel) "
        "image key at load time",
    ),
    # parsed, not ported yet
    "clinical_feature_keys": dict(
        default=None, nargs="+", help="not ported yet"
    ),
    "image_masking": dict(action="store_true",
                          help="Mask image with mask key"),
    "image_crop_from_mask": dict(
        action="store_true", help="Crop image from mask bounding box"),
    "calibration_ids": dict(
        default=None, nargs="+",
        help="Held-out IDs for conformal calibration after training"),
    "conformal_alpha": dict(default=0.2, type=float,
                            help="Conformal miscoverage level alpha"),
    "one_to_one": dict(action="store_true",
                       help="One checkpoint per ID group"),
    "ensemble": dict(
        default=None, choices=["mean", "median"],
        help="Ensembles the predictions of the checkpoints"
    ),
    "skip_keys": dict(default=None, nargs="+", help="not ported yet"),
    "feature_keys": dict(default=None, nargs="+", help="not ported yet"),
    "resize_size": dict(
        default=None, nargs="+", type=int,
        help="Scale each volume to this size after the spacing"
    ),
    "lr_encoder": dict(default=None, type=float, help="not ported yet"),
    "accumulate_grad_batches": dict(
        default=1, type=int, help="Gradient accumulation steps"
    ),
    "logger_type": dict(
        default=None,
        help="wandb | mlflow: a tracker beside the metric CSV (when installed)"
    ),
    "project_name": dict(default=None, help="Tracker project name"),
    "summary_name": dict(default=None, help="Tracker run name"),
    "summary_dir": dict(default="summaries",
                        help="Directory of the wandb run files"),
    "tracking_uri": dict(default=None, help="MLflow tracking URI"),
    "log_model": dict(action="store_true",
                      help="Upload each checkpoint to the tracker"),
    "delete_checkpoints": dict(action="store_true", help="not ported yet"),
    "bottleneck_classification": dict(
        action="store_true", help="Bottleneck classification head"
    ),
    "deep_supervision": dict(action="store_true", help="Deep supervision"),
    "profile_dir": dict(default=None, help="not ported yet"),
    "semi_supervised": dict(action="store_true", help="not ported yet"),
    "semi_sl_weight": dict(type=float, default=0.01, help="not ported yet"),
    "missing_to_empty": dict(default=None, nargs="+", help="not ported yet"),
    "remat": dict(action="store_true", help="not ported yet"),
    "remat_policy": dict(type=str, default=None, help="not ported yet"),
    "res_config_file": dict(default=None, help="not ported yet"),
    "encoder_checkpoint": dict(
        default=None, nargs="+", help="not ported yet"
    ),
    "exclude_from_state_dict": dict(
        default=None, nargs="+", help="Exclude regexes on ckpt load"
    ),
    "freeze_regex": dict(default=None, nargs="+",
                         help="Freeze params matching regex"),
    "not_freeze_regex": dict(default=None, nargs="+",
                             help="Never freeze params matching regex"),
    "config_files": dict(default=None, nargs="+",
                         help="Network YAML configs"),
}


class Parser(argparse.ArgumentParser):
    """argparse with registry lookups: ``add_argument_by_key`` takes keys
    or (key, rename, overrides) triples."""

    def add_argument_by_key(self, keys: List[Any]):
        for key in keys:
            overrides: Dict[str, Any] = {}
            if isinstance(key, (tuple, list)):
                key, rename, overrides = key
            else:
                rename = key
            spec = dict(argument_factory[key])
            spec.update(overrides)
            self.add_argument("--" + rename, dest=rename, **spec)
        return self

    def reject_unported(self, args, keys):
        """Raises ``NotImplementedError`` for each of ``keys`` whose value
        differs from its default."""
        given = [k for k in keys if getattr(args, k) != self.get_default(k)]
        if given:
            raise NotImplementedError(
                f"flags {['--' + k for k in given]} are not ported yet"
            )
