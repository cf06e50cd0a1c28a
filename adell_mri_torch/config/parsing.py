"""
Network-config parsing for U-Net and classifier training.

Counterpart of ``load_yaml``, ``build_compound_loss``, ``parse_config_unet``,
``parse_config_cat``, ``parse_config_ssl``, ``parse_config_2d_classifier_3d``
and ``_TRAINING_KEYS`` in
``adell_mri_tpu/config/parsing.py``: a config file holds hyperparameters
and, for a U-Net, a ``loss_fn`` mapping of loss name -> params that
becomes a ``CompoundLoss``. ``resnet_encoder_config`` is what
``segmentation train --res_config_file`` adds to the U-Net's keys (the
JAX CLI does it inline).
"""

import copy
import inspect
from typing import Any, Dict, Tuple

import yaml

from adell_mri_torch.models.segmentation.losses import (
    CompoundLoss,
    loss_factory,
)

# keys consumed by the training loop rather than the network constructor
_TRAINING_KEYS = (
    "learning_rate",
    "batch_size",
    "weight_decay",
    "loss_fn",
    "momentum",
    "optimizer",
)


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def build_compound_loss(
    loss_spec: Dict[str, Dict[str, Any]],
    n_classes: int = 2,
    param_overrides: Dict[str, Any] = None,
) -> CompoundLoss:
    """``{"dice": {...}, "focal": {...}}`` -> CompoundLoss, binary or
    categorical by ``n_classes``. ``param_overrides`` (e.g. ``--loss_gamma``)
    go into every member loss whose signature takes the key."""
    kind = "categorical" if n_classes > 2 else "binary"
    losses = {}
    for name, params in (loss_spec or {"dice": {}}).items():
        fn = loss_factory[kind][name]
        params = dict(params or {})
        for k, v in (param_overrides or {}).items():
            if v is not None and k in inspect.signature(fn).parameters:
                params[k] = v
        losses[name] = {"fn": fn, "params": params}
    return CompoundLoss(losses)


def parse_config_unet(
    config_file: str,
    n_keys: int = 1,
    n_classes: int = 2,
    loss_param_overrides: Dict[str, Any] = None,
) -> Tuple[Dict[str, Any], CompoundLoss]:
    """Loads a U-Net config, splits training keys from network keys,
    scales ``n_channels`` by the number of image keys and builds the
    loss."""
    config = load_yaml(config_file)
    config["n_channels"] = int(config.get("n_channels", 1)) * n_keys
    loss = build_compound_loss(
        config.get("loss_fn", {"dice": {}}), n_classes,
        param_overrides=loss_param_overrides,
    )
    network_config = {
        k: v for k, v in config.items() if k not in _TRAINING_KEYS
    }
    training_config = {
        k: v for k, v in config.items() if k in _TRAINING_KEYS
    }
    return {
        "network": network_config,
        "training": training_config,
        "n_classes": n_classes,
    }, loss


def parse_config_cat(config_file: str) -> Dict[str, Any]:
    """A classifier config split into ``network`` and ``training`` keys."""
    config = load_yaml(config_file)
    return {
        "network": {k: v for k, v in config.items()
                    if k not in _TRAINING_KEYS},
        "training": {k: v for k, v in config.items()
                     if k in _TRAINING_KEYS},
    }


def parse_config_ssl(config_file: str, dropout_param: float = 0.0,
                     n_keys: int = 1, is_ijepa: bool = False
                     ) -> Dict[str, Any]:
    """A self-supervised config split into ``network`` and ``training``
    keys, with ``dropout_param`` set and, but for I-JEPA, ``n_channels``
    scaled by the number of image keys."""
    config = copy.deepcopy(load_yaml(config_file))
    config["dropout_param"] = dropout_param
    if not is_ijepa:
        config["n_channels"] = int(config.get("n_channels", 1)) * n_keys
    return {
        "network": {k: v for k, v in config.items()
                    if k not in _TRAINING_KEYS},
        "training": {k: v for k, v in config.items()
                     if k in _TRAINING_KEYS},
    }


def parse_config_2d_classifier_3d(config_file: str,
                                  mil_method: str = "standard"
                                  ) -> Dict[str, Any]:
    """The MIL mode's yaml: ``mil_method`` (the yaml's, else the CLI's)
    joins the network keys."""
    config = load_yaml(config_file)
    config["mil_method"] = config.get("mil_method", mil_method)
    return {"network": {k: v for k, v in config.items()
                        if k not in _TRAINING_KEYS},
            "training": {k: v for k, v in config.items()
                         if k in _TRAINING_KEYS}}


def resnet_encoder_config(ssl_config):
    """The U-Net keys that graft the ResNet backbone of an SSL yaml's
    ``backbone_args`` (or of the yaml itself) as the encoder."""
    ba = ssl_config.get("backbone_args", ssl_config)
    structure = [list(s) for s in ba["structure"]]
    pools = ba.get("maxpool_structure", [2] * len(structure))
    depth = [structure[0][0]] + [s[0] for s in structure]
    return {
        "encoder_structure": structure,
        "depth": depth,
        "kernel_sizes": [3] * len(depth),
        # the stem's pool of 2, then the stages'
        "strides": [2] + [list(m) if isinstance(m, (list, tuple)) else m
                          for m in pools],
        "res_type": ba.get("res_type", "resnet"),
    }
