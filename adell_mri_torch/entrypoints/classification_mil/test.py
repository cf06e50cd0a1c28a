"""
``python -m adell_mri_torch classification_mil test``.

Counterpart of ``adell_mri_tpu/entrypoints/classification_mil/test.py``:
the MIL model (``build_mil_model``) and the transforms are rebuilt from
the checkpoint's ``metadata.json`` (``mil_method``, the network keys, the
label mapping), each test case is one forward of its volume in eval mode,
and the binary (sigmoid) or multiclass (softmax) metrics go to the metric
CSV and to one JSON line on standard output. ``--precision bf16`` casts
the weights and the inputs; the logits return to f32.
"""

import json
from typing import NamedTuple

import numpy as np
import torch

from adell_mri_torch.data import Dataset
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification_mil.train import (
    build_mil_model,
)
from adell_mri_torch.eval.metrics import binary_metrics, multiclass_metrics
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


class MILRun(NamedTuple):
    model: torch.nn.Module
    manager: CheckpointManager
    transforms: ClassificationTransforms
    transform_arguments: dict
    n_classes: int
    dtype: torch.dtype


def rebuild(args, device) -> MILRun:
    """The model of ``--checkpoint_dir``'s run (no weights yet), in eval
    mode on ``device``, and the transforms of its training run."""
    mngr = CheckpointManager(args.checkpoint_dir,
                             name=args.checkpoint_name or "mil", fold=0)
    metadata = mngr.load_metadata()
    t_args = metadata.get("transform_arguments", {})
    n_classes = metadata.get("n_classes", args.n_classes)
    image_keys = args.image_keys or t_args.get("image_keys", ["image"])
    model = build_mil_model(metadata.get("network_config", {}),
                            metadata.get("mil_method", "standard"),
                            n_classes, in_channels=len(image_keys))
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
    return MILRun(model.to(device).eval(), mngr, transforms, t_args,
                  n_classes, dtype)


def on_device(run: MILRun, state, device):
    """A checkpoint's weights on ``device`` in the compute dtype."""
    return {k: v.to(device, run.dtype) for k, v in state.items()}


def logits_of(run: MILRun, weights, image: np.ndarray, device):
    """The f32 logits of one loaded case under ``weights``
    (``on_device``)."""
    x = torch.from_numpy(image).to(device=device, dtype=run.dtype)[None]
    with torch.inference_mode():
        out = torch.func.functional_call(run.model, weights, (x,))
    return out[0].float().cpu()


def probabilities(logits, n_classes: int):
    if n_classes == 2:
        return float(torch.sigmoid(logits[0]))
    return torch.softmax(logits, -1).numpy()


def main(arguments):
    parser = Parser(prog="adell classification_mil test")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    device = use_device(args.dev)
    run = rebuild(args, device)
    weights = on_device(run, run.manager.load_state_dict(), device)
    load_fn = run.transforms.load_fn()

    data = Dataset(args.dataset_json)
    pids = args.test_ids or list(data.keys())
    probs, targets = [], []
    for pid in pids:
        if pid not in data.dataset:
            continue
        sample = load_fn({**data[pid], "identifier": pid})
        probs.append(probabilities(
            logits_of(run, weights, sample["image"], device), run.n_classes))
        targets.append(float(sample["label"]))
    metric_fn = binary_metrics if run.n_classes == 2 else multiclass_metrics
    results = metric_fn(np.asarray(probs), np.asarray(targets))
    results["n_cases"] = len(targets)
    MetricLogger(csv_path=args.metric_path).log_metrics(results, step=0)
    print(json.dumps(results))
