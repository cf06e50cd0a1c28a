"""
``python -m adell_mri_torch classification test``.

Counterpart of ``adell_mri_tpu/entrypoints/classification/test.py``: the
network (running statistics included) and the transforms are rebuilt
from the checkpoint (``predict.load_classifier``), each test case runs
through one forward in eval mode, and ``binary_metrics`` (the sigmoid of
the one logit) or ``multiclass_metrics`` (the softmax, or OrdNet's class
probabilities from its cumulative logits) of the cases' probabilities
against their mapped labels, with ``n_cases``, go to the
metric CSV and to one JSON line on standard output, with ``iteration``
and ``checkpoint`` (the fold directory). Each ``--test_ids`` entry is a
group of IDs (a file or a comma-separated list): one group (or none:
every case) prints its metrics, several print a list of them. A
checkpoint trained with clinical features feeds each case's
``features`` to its ``HybridClassifier``. Several checkpoints and
``--one_to_one`` are not ported yet.
"""

import json

import numpy as np

from adell_mri_torch.data import Dataset
from adell_mri_torch.data.dataset import parse_ids
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification.predict import (
    class_probabilities,
    forward,
    load_classifier,
    net_type_of,
)
from adell_mri_torch.eval.metrics import binary_metrics, multiclass_metrics
from adell_mri_torch.train.logging_utils import MetricLogger

ARG_KEYS = [
    "dataset_json",
    ("image_keys", "image_keys", dict(required=False, default=None)),
    "test_ids",
    "checkpoint_dir",
    "checkpoint_name",
    "n_classes",
    "metric_path",
    "dev",
    "seed",
    "classification_net_type",
    "precision",
]
UNPORTED_KEYS = ["checkpoint", "one_to_one"]


def main(arguments):
    parser = Parser(prog="adell classification test")
    parser.add_argument_by_key(ARG_KEYS + UNPORTED_KEYS)
    args = parser.parse_args(arguments)
    parser.reject_unported(args, UNPORTED_KEYS)
    device = use_device(args.dev)
    clf = load_classifier(args, device)
    n_classes = clf.metadata.get("n_classes", args.n_classes)
    net_type = net_type_of(args, clf.metadata)
    load_fn = clf.transforms.load_fn()

    data = Dataset(args.dataset_json)
    groups = (parse_ids(list(args.test_ids), "nested_list")
              if args.test_ids else [list(data.keys())])
    groups = [[pid for pid in g if pid in data.dataset] for g in groups]
    mlog = MetricLogger(csv_path=args.metric_path)
    all_results = []
    for iteration, group in enumerate(groups):
        probs, targets = [], []
        for pid in group:
            sample = load_fn({**data[pid], "identifier": pid})
            probs.append(class_probabilities(
                forward(clf, sample, device), n_classes, net_type))
            targets.append(float(sample["label"]))
        metric_fn = binary_metrics if n_classes == 2 else multiclass_metrics
        results = metric_fn(np.asarray(probs), np.asarray(targets))
        results["n_cases"] = len(targets)
        mlog.log_metrics(results, step=0, checkpoint=clf.dir,
                         iteration=iteration)
        all_results.append({"iteration": iteration, "checkpoint": clf.dir,
                            **results})
    print(json.dumps(all_results[0] if len(all_results) == 1
                     else all_results))
