"""
``python -m adell_mri_torch classification predict``.

Counterpart of ``adell_mri_tpu/entrypoints/classification/predict.py``:
the network and the transforms are rebuilt from the checkpoint's
``metadata.json`` and its weights (running statistics included) from
``model.pt``; each case is one forward of its ``target_size`` volume in
eval mode. ``--prediction_type probability`` (the sigmoid of a binary
model, else the softmax, or for OrdNet the class probabilities of its
cumulative logits, ``ordinal_to_class_probs``), ``logit`` or
``features`` (the pooled backbone features; the JAX CLI refuses it for
``ord``, ``unet``, ``vit`` and ``factorized_vit``, whose modules take no
``return_features``, and so does this one); ``pre_bias`` returns
OrdNet's score before its thresholds and falls back to probabilities
for every other net, as the JAX CLI does. The two ViT classifiers are
built for the checkpoint's ``target_size``. A checkpoint trained with
``--mask_keys`` and ``--image_masking`` or ``--image_crop_from_mask``
masks or crops each case by its mask. One ``--prediction_ids`` group (or
none: every case) writes the JAX CLI's ``{id: value}`` map, several write
its list of
records (``iteration``, ``prediction_ids``, ``checkpoint``,
``predictions``), to ``--output_path`` and to standard output.
``--precision bf16`` casts the weights and the inputs; the running
statistics stay f32, as in the JAX package. A checkpoint trained with
clinical features rebuilds its ``HybridClassifier`` (the features'
mean and standard deviation from ``metadata.json``) and feeds each case's
``features``; it has no ``features`` or ``pre_bias`` prediction type, as
the JAX one has none. Several checkpoints,
``--one_to_one``, ``--ensemble`` and conformal sets are not ported yet.
"""

import json
import logging
from typing import NamedTuple

import torch

from adell_mri_torch.config.factories import get_classification_network
from adell_mri_torch.models.classification.losses import (
    ordinal_to_class_probs,
)
from adell_mri_torch.data import Dataset
from adell_mri_torch.data.dataset import parse_ids
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.precision import compute_dtype
from adell_mri_torch.transforms.pipeline import ClassificationTransforms

logger = logging.getLogger(__name__)

ARG_KEYS = [
    "dataset_json",
    ("image_keys", "image_keys", dict(required=False, default=None)),
    "prediction_ids",
    "checkpoint_dir",
    "checkpoint_name",
    "n_classes",
    "output_path",
    ("prediction_type", "prediction_type", dict(
        help="probability|logit|features|pre_bias (OrdNet only; else "
        "probability)")),
    "dev",
    "seed",
    "classification_net_type",
    "precision",
]
UNPORTED_KEYS = ["checkpoint", "one_to_one", "ensemble"]
PREDICTION_TYPES = ("probability", "logit", "features", "pre_bias")
# the JAX modules of these net types take no return_features
NO_FEATURES = {"ord": "OrdNet", "unet": "UNetEncoderClassifier",
               "vit": "ViTClassifier",
               "factorized_vit": "FactorizedViTClassifier"}


class Classifier(NamedTuple):
    model: torch.nn.Module
    metadata: dict
    transforms: ClassificationTransforms
    dtype: torch.dtype
    dir: str  # the fold directory, the JAX CLI's checkpoint label


def load_classifier(args, device) -> Classifier:
    """The classifier of ``--checkpoint_dir``'s fold 0: the model in eval
    mode on ``device``, its parameters in the compute dtype and its
    running statistics f32; the transforms rebuild the training run's
    loading and label mapping."""
    dtype = compute_dtype(args.precision) or torch.float32
    mngr = CheckpointManager(
        args.checkpoint_dir, name=args.checkpoint_name or "classification",
        fold=0,
    )
    metadata = mngr.load_metadata()
    t_args = metadata.get("transform_arguments", {})
    if t_args.get("resize_size"):
        raise NotImplementedError(
            "checkpoints trained with a resize are not ported yet")
    image_keys = args.image_keys or t_args.get("image_keys", ["image"])
    model = get_classification_network(
        net_type_of(args, metadata),
        metadata.get("network_config", {}),
        n_classes=metadata.get("n_classes", args.n_classes),
        in_channels=len(image_keys),
        clinical_feature_means=metadata.get("clinical_feature_means"),
        clinical_feature_stds=metadata.get("clinical_feature_stds"),
        image_size=t_args.get("target_size"),
    )
    model.load_state_dict(mngr.load_state_dict())
    model = model.to(device).eval()
    for p in model.parameters():
        p.data = p.data.to(dtype)
    transforms = ClassificationTransforms(
        image_keys=image_keys,
        label_key=t_args.get("label_key", "label"),
        target_spacing=t_args.get("target_spacing"),
        target_size=tuple(t_args.get("target_size")),
        adc_keys=t_args.get("adc_keys") or (),
        positive_labels=t_args.get("positive_labels"),
        possible_labels=t_args.get("possible_labels"),
        label_groups=t_args.get("label_groups"),
        clinical_feature_keys=t_args.get("clinical_feature_keys") or (),
        mask_key=t_args.get("mask_key"),
        image_masking=bool(t_args.get("image_masking")),
        image_crop_from_mask=bool(t_args.get("image_crop_from_mask")),
    )
    return Classifier(model, metadata, transforms, dtype, mngr.dir)


def net_type_of(args, metadata) -> str:
    return metadata.get("net_type", args.classification_net_type)


def class_probabilities(logits, n_classes: int, net_type: str):
    """A case's probabilities from its f32 logits: the sigmoid of a binary
    model's one logit (a float), else the class probabilities, OrdNet's
    from its cumulative logits."""
    if n_classes == 2:
        return float(torch.sigmoid(logits[0]))
    if net_type == "ord":
        return ordinal_to_class_probs(logits).numpy()
    return torch.softmax(logits, -1).numpy()


def forward(clf: Classifier, sample, device, **kwargs):
    """The f32 output of one loaded case: its ``image`` [*S, C] and, for a
    hybrid classifier, its ``features`` [F] (numpy), in the compute
    dtype."""
    inputs = [sample["image"]]
    if clf.transforms.clinical_feature_keys:
        inputs.append(sample["features"])
    inputs = [torch.from_numpy(a).to(device=device, dtype=clf.dtype)[None]
              for a in inputs]
    with torch.inference_mode():
        return clf.model(*inputs, **kwargs)[0].float().cpu()


def main(arguments):
    parser = Parser(prog="adell classification predict")
    parser.add_argument_by_key(ARG_KEYS + UNPORTED_KEYS)
    args = parser.parse_args(arguments)
    parser.reject_unported(args, UNPORTED_KEYS)
    prediction_type = args.prediction_type
    if prediction_type not in PREDICTION_TYPES:
        raise NotImplementedError(
            f"--prediction_type {prediction_type} is not ported yet (the "
            f"port has {', '.join(PREDICTION_TYPES)})"
        )
    device = use_device(args.dev)
    clf = load_classifier(args, device)
    net_type = net_type_of(args, clf.metadata)
    if prediction_type == "pre_bias" and net_type != "ord":
        logger.warning(
            "Net type must be ord for pre_bias, using probability instead")
        prediction_type = "probability"
    kwargs = {"features": {"return_features": True},
              "pre_bias": {"return_only_pre_bias": True}}.get(
                  prediction_type, {})
    if kwargs:
        module = ("HybridClassifier" if clf.transforms.clinical_feature_keys
                  else NO_FEATURES.get(net_type) if prediction_type
                  == "features" else None)
        if module:
            raise ValueError(
                f"--prediction_type {prediction_type} is not supported by "
                f"net_type {net_type!r} ({module} takes no "
                f"{next(iter(kwargs))})")
    n_classes = clf.metadata.get("n_classes", args.n_classes)
    load_fn = clf.transforms.load_fn()

    data = Dataset(args.dataset_json)
    groups = (parse_ids(list(args.prediction_ids), "nested_list")
              if args.prediction_ids else [list(data.keys())])
    groups = [[pid for pid in g if pid in data.dataset] for g in groups]

    def predict_one(pid):
        out = forward(clf, load_fn({**data[pid], "identifier": pid}),
                      device, **kwargs)
        if prediction_type != "probability":
            return out.tolist()
        probs = class_probabilities(out, n_classes, net_type)
        return probs if n_classes == 2 else probs.tolist()

    records = [
        {"iteration": i, "prediction_ids": list(group),
         "checkpoint": clf.dir,
         "predictions": {pid: predict_one(pid) for pid in group}}
        for i, group in enumerate(groups)
    ]
    out = records[0]["predictions"] if len(records) == 1 else records
    with open(args.output_path, "w") as f:
        json.dump(out, f)
    print(json.dumps(out))
