"""
``python -m adell_mri_torch classification predict``.

Counterpart of ``adell_mri_tpu/entrypoints/classification/predict.py``:
the network and the transforms are rebuilt from ``--checkpoint_dir``'s
``metadata.json`` (a ``--resize_size`` run's cases are scaled as in
training), the weights (running statistics included) come from its
``model.pt`` or from each ``--checkpoint`` run directory's; each case is
one forward of its ``target_size`` volume in eval mode.
``--prediction_type probability`` (the sigmoid of a binary model, else
the softmax, or for OrdNet the class probabilities of its cumulative
logits, ``ordinal_to_class_probs``), ``logit``, ``features`` (the pooled
backbone features; the JAX CLI refuses it for ``ord``, ``unet``, ``vit``
and ``factorized_vit``, whose modules take no ``return_features``, and
so does this one), ``set`` (the conformal prediction set of each case, as
class indices, from the ``q_hat`` that ``train --calibration_ids`` wrote
to the default ``--checkpoint_dir``'s ``conformal.json``, for every
checkpoint, as the JAX CLI reads it); ``pre_bias`` returns OrdNet's score
before its thresholds and falls back to probabilities for every other
net, as the JAX CLI does. The two ViT classifiers are built for the
checkpoint's ``target_size``. A checkpoint trained with ``--mask_keys``
and ``--image_masking`` or ``--image_crop_from_mask`` masks or crops each
case by its mask. Where any checkpoint has a ``gp_covariance.npy`` (a GP
head, ``train`` fitted it), the logits of every checkpoint take the
mean-field correction (``predictive_logits``; a checkpoint without one
takes a zero covariance, which leaves its logits as they are), except
for ``features`` and ``pre_bias``. The JAX CLI's records
(``prediction_utils.run_prediction_matrix``): one checkpoint, one
``--prediction_ids`` group and no ``--one_to_one`` or ``--ensemble``
write its ``{id: value}`` map, anything else its list of records
(``iteration``, ``prediction_ids``, ``checkpoint``, ``predictions``),
with ``--ensemble mean|median`` an aggregate record last (not of sets),
to ``--output_path`` and to standard output. ``--precision bf16`` casts
the weights and the inputs; the running statistics and a GP head's
random features stay f32, as in the JAX package. A checkpoint trained
with clinical features rebuilds its ``HybridClassifier`` (the features'
mean and standard deviation from ``metadata.json``) and feeds each case's
``features``; it has no ``features`` or ``pre_bias`` prediction type, as
the JAX one has none.
"""

import json
import logging
import os
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from adell_mri_torch.config.factories import get_classification_network
from adell_mri_torch.data import Dataset
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.prediction_utils import (
    prediction_id_groups,
    resolve_checkpoint_variables,
    run_prediction_matrix,
)
from adell_mri_torch.models.classification.losses import (
    ordinal_to_class_probs,
)
from adell_mri_torch.models.layers.conformal import AdaptivePredictionSets
from adell_mri_torch.models.layers.gaussian_process import predictive_logits
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
    "checkpoint",
    "one_to_one",
    "ensemble",
    "n_classes",
    "output_path",
    ("prediction_type", "prediction_type", dict(
        help="probability|logit|features|pre_bias (OrdNet only; else "
        "probability)|set (conformal prediction sets; needs a calibrated "
        "checkpoint)")),
    "dev",
    "seed",
    "classification_net_type",
    "precision",
]
PREDICTION_TYPES = ("probability", "logit", "features", "pre_bias", "set")
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
    # (label, weights on the device) of each checkpoint to serve
    checkpoints: List[Tuple[str, Dict[str, torch.Tensor]]]


def load_classifier(args, device) -> Classifier:
    """The classifier of ``--checkpoint_dir``'s fold 0: the model in eval
    mode on ``device`` and the transforms that rebuild the training run's
    loading and label mapping, from its metadata; the weights of each
    ``--checkpoint`` (else of that fold), the parameters in the compute
    dtype and the buffers (running statistics, a GP head's random
    features) f32."""
    dtype = compute_dtype(args.precision) or torch.float32
    mngr = CheckpointManager(
        args.checkpoint_dir, name=args.checkpoint_name or "classification",
        fold=0,
    )
    metadata = mngr.load_metadata()
    t_args = metadata.get("transform_arguments", {})
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
    model = model.to(device).eval()
    names = {k for k, _ in model.named_parameters()}
    expected = set(model.state_dict())

    def on_device(label, state):
        missing = expected - set(state)
        if missing:
            raise KeyError(f"{label}: no {sorted(missing)[0]} in its weights")
        return {k: v.to(device, dtype if k in names else torch.float32)
                for k, v in state.items()}

    checkpoints = [
        (label, on_device(label, state)) for label, state in
        resolve_checkpoint_variables(getattr(args, "checkpoint", None), mngr)
    ]
    transforms = ClassificationTransforms(
        image_keys=image_keys,
        label_key=t_args.get("label_key", "label"),
        target_spacing=t_args.get("target_spacing"),
        target_size=tuple(t_args.get("target_size")),
        resize_size=t_args.get("resize_size"),
        adc_keys=t_args.get("adc_keys") or (),
        positive_labels=t_args.get("positive_labels"),
        possible_labels=t_args.get("possible_labels"),
        label_groups=t_args.get("label_groups"),
        clinical_feature_keys=t_args.get("clinical_feature_keys") or (),
        mask_key=t_args.get("mask_key"),
        image_masking=bool(t_args.get("image_masking")),
        image_crop_from_mask=bool(t_args.get("image_crop_from_mask")),
    )
    return Classifier(model, metadata, transforms, dtype, mngr.dir,
                      checkpoints)


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


def forward(clf: Classifier, weights, sample, device, **kwargs):
    """The f32 output of one loaded case under ``weights`` (a
    checkpoint's): its ``image`` [*S, C] and, for a hybrid classifier, its
    ``features`` [F] (numpy), in the compute dtype. With ``return_phi``
    (a GP head) the pair of logits and random features."""
    inputs = [sample["image"]]
    if clf.transforms.clinical_feature_keys:
        inputs.append(sample["features"])
    inputs = tuple(torch.from_numpy(a).to(device=device, dtype=clf.dtype)
                   [None] for a in inputs)
    with torch.inference_mode():
        out = torch.func.functional_call(clf.model, weights, inputs, kwargs)
    if isinstance(out, tuple):
        return tuple(o[0].float().cpu() for o in out)
    return out[0].float().cpu()


def gp_covariances(checkpoints) -> Dict[str, torch.Tensor]:
    """Each checkpoint's ``gp_covariance.npy`` (f32), a zero matrix of the
    same size where one lacks it; empty when none has one."""
    covs = {label: (np.load(os.path.join(label, "gp_covariance.npy"))
                    if os.path.exists(os.path.join(label,
                                                   "gp_covariance.npy"))
                    else None)
            for label, _ in checkpoints}
    found = [c for c in covs.values() if c is not None]
    if not found:
        return {}
    d = found[0].shape[0]
    return {label: torch.from_numpy(np.asarray(
        c if c is not None else np.zeros((d, d)), np.float32))
        for label, c in covs.items()}


def main(arguments):
    parser = Parser(prog="adell classification predict")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    prediction_type = args.prediction_type
    if prediction_type not in PREDICTION_TYPES:
        raise NotImplementedError(
            f"--prediction_type {prediction_type} is not ported yet (the "
            f"port has {', '.join(PREDICTION_TYPES)})"
        )
    if args.ensemble is not None and prediction_type == "set":
        raise ValueError(
            "--ensemble cannot aggregate --prediction_type set outputs; "
            "ensemble the probabilities instead and calibrate on them")
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
    covs = gp_covariances(clf.checkpoints)
    if covs and kwargs:
        logger.info(
            "gp_covariance.npy present but --prediction_type %s requests "
            "raw outputs; skipping the GP correction", prediction_type)
        covs = {}
    aps = None
    if prediction_type == "set":
        conf_path = os.path.join(clf.dir, "conformal.json")
        if not os.path.exists(conf_path):
            raise FileNotFoundError(
                f"--prediction_type set needs {conf_path}; train with "
                "--calibration_ids first")
        with open(conf_path) as f:
            conf = json.load(f)
        aps = AdaptivePredictionSets(alpha=conf.get("alpha", 0.2))
        aps.q_hat = conf["q_hat"]
    n_classes = clf.metadata.get("n_classes", args.n_classes)
    load_fn = clf.transforms.load_fn()
    data = Dataset(args.dataset_json)
    groups = prediction_id_groups(args.prediction_ids, data)

    def predict_one(weights, pid, label):
        sample = load_fn({**data[pid], "identifier": pid})
        if covs:
            logits, phi = forward(clf, weights, sample, device,
                                  return_phi=True)
            out = predictive_logits(logits[None], phi[None],
                                    covs[label])[0]
        else:
            out = forward(clf, weights, sample, device, **kwargs)
        if prediction_type in ("logit", "features", "pre_bias"):
            return out.tolist()
        probs = class_probabilities(out, n_classes, net_type)
        if prediction_type == "set":
            row = [1.0 - probs, probs] if n_classes == 2 else probs
            members = aps(np.asarray([row]))[0]
            return [int(i) for i in np.nonzero(members)[0]]
        return probs if n_classes == 2 else probs.tolist()

    records = run_prediction_matrix(groups, clf.checkpoints, predict_one,
                                    one_to_one=args.one_to_one,
                                    ensemble=args.ensemble)
    legacy = (not args.checkpoint and args.ensemble is None
              and not args.one_to_one and len(groups) == 1)
    out = records[0]["predictions"] if legacy else records
    with open(args.output_path, "w") as f:
        json.dump(out, f)
    print(json.dumps(out))
