"""
``python -m adell_mri_torch classification_deconfounder test``.

Counterpart of ``adell_mri_tpu/entrypoints/classification_deconfounder/
test.py``: the ``DeconfoundedNet`` rebuilt from the checkpoint's
``metadata.json`` (the surrogate heads from ``cat_confounder_cards`` and
``cont_confounder_keys``) and its ``model.pt``; each case one forward
applying the parameters alone, as the JAX CLI's (batch norms by the
case's own statistics); ``binary_metrics`` of the sigmoid of the logit
(``multiclass_metrics`` of the softmax above two classes) against the
mapped labels, with ``n_cases``, to the metric CSV and to standard
output. ``--precision bf16`` casts the parameters and the image.
"""

import json
from typing import NamedTuple

import numpy as np
import torch

from adell_mri_torch.data import Dataset
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification_deconfounder.train import (
    build_deconfounder_model,
)
from adell_mri_torch.eval.metrics import binary_metrics, multiclass_metrics
from adell_mri_torch.models.layers.adn import batch_statistics_mode
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.logging_utils import MetricLogger
from adell_mri_torch.train.precision import compute_dtype
from adell_mri_torch.transforms.pipeline import ClassificationTransforms

ARG_KEYS = [
    "dataset_json",
    ("image_keys", "image_keys", dict(required=False, default=None)),
    "test_ids",
    "checkpoint_dir",
    "checkpoint_name",
    "n_classes",
    "metric_path",
    "dev",
    "precision",
    "seed",
]


class Deconfounder(NamedTuple):
    model: torch.nn.Module
    manager: CheckpointManager
    transforms: ClassificationTransforms
    t_args: dict
    n_classes: int
    dtype: torch.dtype
    device: torch.device

    def weights(self, state):
        """A checkpoint's state dict on the device, the parameters in the
        compute dtype."""
        return {k: v.to(self.device, self.dtype) for k, v in state.items()}

    def forward(self, weights, image):
        """The f32 ``(logits, [categorical logits], continuous or None)``
        of one case's image ``[*S, C]`` (numpy)."""
        x = torch.from_numpy(image)[None].to(self.device, self.dtype)
        with torch.inference_mode(), batch_statistics_mode(self.model):
            logits, cat_preds, cont_pred, _ = torch.func.functional_call(
                self.model, weights, (x,))
        return (logits[0].float().cpu(),
                [c[0].float().cpu() for c in cat_preds],
                None if cont_pred is None else cont_pred[0].float().cpu())


def rebuild(args) -> Deconfounder:
    """The model, its checkpoint manager and the transforms of
    ``--checkpoint_dir``'s metadata (the caller restores the weights)."""
    device = use_device(args.dev)
    mngr = CheckpointManager(
        args.checkpoint_dir, name=args.checkpoint_name or "deconfounder",
        fold=0)
    metadata = mngr.load_metadata()
    t_args = metadata.get("transform_arguments", {})
    n_classes = metadata.get("n_classes", args.n_classes)
    image_keys = args.image_keys or t_args.get("image_keys", ["image"])
    model = build_deconfounder_model(
        metadata.get("network_config", {}),
        metadata.get("cat_confounder_cards", []),
        len(metadata.get("cont_confounder_keys", [])), n_classes,
        # checkpoints that predate the key used the model default
        n_features=metadata.get("n_features_deconfounder", 32),
        in_channels=len(image_keys)).to(device).eval()
    transforms = ClassificationTransforms(
        image_keys=image_keys,
        label_key=t_args.get("label_key", "label"),
        target_spacing=t_args.get("target_spacing"),
        target_size=tuple(t_args.get("target_size")),
        positive_labels=t_args.get("positive_labels"),
        possible_labels=t_args.get("possible_labels"),
        label_groups=t_args.get("label_groups"),
    )
    dtype = compute_dtype(args.precision) or torch.float32
    return Deconfounder(model, mngr, transforms, t_args, n_classes, dtype,
                        device)


def main(arguments):
    parser = Parser(prog="adell classification_deconfounder test")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    dec = rebuild(args)
    weights = dec.weights(dec.manager.load_state_dict())
    load_fn = dec.transforms.load_fn()

    data = Dataset(args.dataset_json)
    pids = args.test_ids or list(data.keys())
    probs, targets = [], []
    for pid in pids:
        if pid not in data.dataset:
            continue
        sample = load_fn({**data[pid], "identifier": pid})
        logits = dec.forward(weights, sample["image"])[0]
        if dec.n_classes == 2:
            probs.append(float(torch.sigmoid(logits[0])))
        else:
            probs.append(torch.softmax(logits, -1).numpy())
        targets.append(float(sample["label"]))
    metric_fn = binary_metrics if dec.n_classes == 2 else multiclass_metrics
    results = metric_fn(np.asarray(probs), np.asarray(targets))
    results["n_cases"] = len(targets)
    MetricLogger(csv_path=args.metric_path).log_metrics(results, step=0)
    print(json.dumps(results))
