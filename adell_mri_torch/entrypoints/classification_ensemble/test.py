"""
``python -m adell_mri_torch classification_ensemble test``.

Counterpart of ``adell_mri_tpu/entrypoints/classification_ensemble/
test.py``: the ensemble's probabilities (``predict.load_ensemble``, the
parameters alone) of every ``--test_ids`` ID (the IDs as given, else
every case) that has ``--label_keys``, against the mapped labels:
``binary_metrics`` or ``multiclass_metrics`` with ``n_cases``, to the
metric CSV and as one JSON line on standard output.
"""

import json

import numpy as np

from adell_mri_torch.data import Dataset
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification_ensemble.predict import (
    load_ensemble,
)
from adell_mri_torch.eval.metrics import binary_metrics, multiclass_metrics
from adell_mri_torch.train.logging_utils import MetricLogger

ARG_KEYS = [
    "dataset_json",
    ("label_keys", "label_keys", dict(nargs=None, default="label")),
    "test_ids",
    "checkpoint_dir",
    "checkpoint_name",
    "metric_path",
    "dev",
    "precision",
    "seed",
]


def main(arguments):
    parser = Parser(prog="adell classification_ensemble test")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    device = use_device(args.dev)
    ens = load_ensemble(args.checkpoint_dir, args.checkpoint_name, device,
                        args.precision)
    label_key = args.label_keys or ens.metadata["transform_arguments"].get(
        "label_key", "label")
    load_fn = ens.transforms(label_key=label_key).load_fn()
    data = Dataset(args.dataset_json)
    probs, targets = [], []
    for pid in args.test_ids or list(data.keys()):
        if pid not in data.dataset or label_key not in data[pid]:
            continue
        sample = load_fn({**data[pid], "identifier": pid})
        probs.append(ens.probability(sample["image"], device))
        targets.append(float(sample["label"]))
    metric_fn = (multiclass_metrics if ens.metadata.get("n_classes", 2) > 2
                 else binary_metrics)
    results = metric_fn(np.asarray(probs), np.asarray(targets))
    results["n_cases"] = len(targets)
    MetricLogger(csv_path=args.metric_path).log_metrics(results, step=0)
    print(json.dumps(results))
