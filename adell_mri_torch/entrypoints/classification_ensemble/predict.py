"""
``python -m adell_mri_torch classification_ensemble predict``.

Counterpart of ``adell_mri_tpu/entrypoints/classification_ensemble/
predict.py``: the ``GenericEnsemble`` rebuilt from the checkpoint's
``metadata.json`` (``member_configs``, ``net_type``, ``n_classes``) and
``model.pt``; each case (read, resampled and scaled to the training
``target_size``) is one forward applying the parameters alone, as the
JAX CLI's (batch norms by the case's own statistics), and its
probability (the sigmoid, or the softmax when multiclass) goes into one
``{id: value}`` map, written to ``--output_path`` and printed.
``--prediction_ids`` are IDs as given. ``--precision bf16`` casts the
parameters and the image.
"""

import json
import logging
from typing import NamedTuple

import torch

from adell_mri_torch.data import Dataset
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification_ensemble.train import (
    ensemble_network,
)
from adell_mri_torch.models.layers.adn import batch_statistics_mode
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
    "output_path",
    "dev",
    "precision",
    "seed",
]


class Ensemble(NamedTuple):
    model: torch.nn.Module
    metadata: dict
    dtype: torch.dtype

    def transforms(self, image_keys=None, label_key=None):
        t_args = self.metadata["transform_arguments"]
        return ClassificationTransforms(
            image_keys=image_keys or t_args["image_keys"],
            label_key=label_key,
            target_spacing=t_args.get("target_spacing"),
            target_size=tuple(t_args["target_size"]),
            positive_labels=t_args.get("positive_labels"),
            possible_labels=t_args.get("possible_labels"),
            label_groups=t_args.get("label_groups"),
        )

    def probability(self, image, device):
        """The f32 probabilities of one case [*S, C] (numpy): a float
        (binary) or a list."""
        x = torch.from_numpy(image).to(device, self.dtype)[None]
        with torch.inference_mode(), batch_statistics_mode(self.model):
            logits = self.model(x)[0].float().cpu()
        if self.metadata.get("n_classes", 2) > 2:
            return torch.softmax(logits, -1).tolist()
        return float(torch.sigmoid(logits[0]))


def load_ensemble(checkpoint_dir, checkpoint_name, device,
                  precision=None) -> Ensemble:
    """The ensemble of ``{checkpoint_dir}/{name}_fold0`` (name "ensemble"
    by default) in eval mode on ``device``, its parameters in the compute
    dtype."""
    mngr = CheckpointManager(checkpoint_dir,
                             name=checkpoint_name or "ensemble", fold=0)
    meta = mngr.load_metadata()
    if not meta.get("member_configs"):
        raise ValueError(
            "checkpoint metadata lacks member_configs — retrain with the "
            "current classification_ensemble train")
    t_args = meta["transform_arguments"]
    model = ensemble_network(meta.get("net_type", "cat"),
                             meta["member_configs"],
                             meta.get("n_classes", 2),
                             len(t_args["image_keys"]))
    model.load_state_dict(mngr.load_state_dict())
    dtype = compute_dtype(precision) or torch.float32
    model = model.to(device).eval()
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return Ensemble(model, meta, dtype)


def main(arguments):
    parser = Parser(prog="adell classification_ensemble predict")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    device = use_device(args.dev)
    ens = load_ensemble(args.checkpoint_dir, args.checkpoint_name, device,
                        args.precision)
    load_fn = ens.transforms(args.image_keys).load_fn()
    data = Dataset(args.dataset_json)
    results = {}
    for pid in args.prediction_ids or list(data.keys()):
        if pid not in data.dataset:
            continue
        sample = load_fn({**data[pid], "identifier": pid})
        results[pid] = ens.probability(sample["image"], device)
        logger.info("%s -> %s", pid, results[pid])
    out = json.dumps(results)
    if args.output_path:
        with open(args.output_path, "w") as f:
            f.write(out)
    print(out)
