"""
``python -m adell_mri_torch classification test``.

Counterpart of ``adell_mri_tpu/entrypoints/classification/test.py``: the
network and the transforms are rebuilt from ``--checkpoint_dir``'s
metadata and the weights (running statistics included) from its
``model.pt`` or from each ``--checkpoint`` run directory's
(``predict.load_classifier``); each test case runs through one forward
in eval mode, and ``binary_metrics`` (the sigmoid of the one logit) or
``multiclass_metrics`` (the softmax, or OrdNet's class probabilities
from its cumulative logits) of the cases' probabilities against their
mapped labels, with ``n_cases``, go to the metric CSV and to standard
output with ``iteration`` and ``checkpoint`` (the checkpoint's label).
Each ``--test_ids`` entry is a group of IDs (a file or a comma-separated
list); every checkpoint serves every group, or with ``--one_to_one``
checkpoint ``i`` group ``i`` (a ValueError with fewer checkpoints than
groups), through ``run_prediction_matrix``. One checkpoint, one group
and no ``--one_to_one`` print the metrics alone, anything else the list
of them, as the JAX CLI does. A checkpoint trained with clinical
features feeds each case's ``features`` to its ``HybridClassifier``. No
GP correction is applied, as in the JAX CLI.
"""

import json

import numpy as np

from adell_mri_torch.data import Dataset
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification.predict import (
    class_probabilities,
    forward,
    load_classifier,
    net_type_of,
)
from adell_mri_torch.entrypoints.prediction_utils import (
    prediction_id_groups,
    run_prediction_matrix,
)
from adell_mri_torch.eval.metrics import binary_metrics, multiclass_metrics
from adell_mri_torch.train.logging_utils import MetricLogger

ARG_KEYS = [
    "dataset_json",
    ("image_keys", "image_keys", dict(required=False, default=None)),
    "test_ids",
    "checkpoint_dir",
    "checkpoint_name",
    "checkpoint",
    "one_to_one",
    "n_classes",
    "metric_path",
    "dev",
    "seed",
    "classification_net_type",
    "precision",
]


def main(arguments):
    parser = Parser(prog="adell classification test")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    device = use_device(args.dev)
    clf = load_classifier(args, device)
    n_classes = clf.metadata.get("n_classes", args.n_classes)
    net_type = net_type_of(args, clf.metadata)
    load_fn = clf.transforms.load_fn()

    data = Dataset(args.dataset_json)
    groups = prediction_id_groups(args.test_ids, data)

    def predict_one(weights, pid, label):
        sample = load_fn({**data[pid], "identifier": pid})
        return (class_probabilities(forward(clf, weights, sample, device),
                                    n_classes, net_type),
                float(sample["label"]))

    metric_fn = binary_metrics if n_classes == 2 else multiclass_metrics
    mlog = MetricLogger(csv_path=args.metric_path)
    all_results = []
    for record in run_prediction_matrix(groups, clf.checkpoints,
                                        predict_one,
                                        one_to_one=args.one_to_one):
        pairs = [record["predictions"][pid]
                 for pid in record["prediction_ids"]]
        probs, targets = [p for p, _ in pairs], [t for _, t in pairs]
        results = metric_fn(np.asarray(probs), np.asarray(targets))
        results["n_cases"] = len(targets)
        mlog.log_metrics(results, step=0, checkpoint=record["checkpoint"],
                         iteration=record["iteration"])
        all_results.append({"iteration": record["iteration"],
                            "checkpoint": record["checkpoint"], **results})
    legacy = not args.checkpoint and not args.one_to_one and len(groups) == 1
    print(json.dumps(all_results[0] if legacy else all_results))
