"""
``python -m adell_mri_torch classification_mil predict``.

Counterpart of ``adell_mri_tpu/entrypoints/classification_mil/predict.py``:
the MIL model and the transforms are rebuilt from ``--checkpoint_dir``'s
metadata (``test.rebuild``), the weights come from its ``model.pt`` or
from each ``--checkpoint`` run directory's, and each case's probability
(the sigmoid of a binary model's logit, else the softmax) or, with
``--prediction_type logit``, its logits go through the JAX CLI's records
(``prediction_utils.run_prediction_matrix``: ``--prediction_ids`` groups,
``--one_to_one``, ``--ensemble mean|median``). One checkpoint, one group
and neither flag write the ``{id: value}`` map, anything else the list of
records, to ``--output_path`` and to standard output. A case without a
label loads with the first label the training run's mapping accepts.
"""

import json

from adell_mri_torch.data import Dataset
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification_mil.test import (
    logits_of,
    on_device,
    probabilities,
    rebuild,
)
from adell_mri_torch.entrypoints.prediction_utils import (
    prediction_id_groups,
    resolve_checkpoint_variables,
    run_prediction_matrix,
)

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
    "prediction_type",
    "dev",
    "precision",
    "seed",
]


def main(arguments):
    parser = Parser(prog="adell classification_mil predict")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    device = use_device(args.dev)
    run = rebuild(args, device)
    checkpoints = [(label, on_device(run, state, device)) for label, state
                   in resolve_checkpoint_variables(args.checkpoint,
                                                   run.manager)]
    t_args = run.transform_arguments
    label_key = t_args.get("label_key", "label")
    groups_of_labels = t_args.get("label_groups")
    possible = t_args.get("possible_labels")
    placeholder = (groups_of_labels[0][0] if groups_of_labels
                   else possible[0] if possible else 0)
    load_fn = run.transforms.load_fn()
    data = Dataset(args.dataset_json)
    groups = prediction_id_groups(args.prediction_ids, data)

    def predict_one(weights, pid, label):
        entry = {**data[pid], "identifier": pid}
        entry.setdefault(label_key, placeholder)
        logits = logits_of(run, weights, load_fn(entry)["image"], device)
        if args.prediction_type == "logit":
            return logits.tolist()
        probs = probabilities(logits, run.n_classes)
        return probs if run.n_classes == 2 else probs.tolist()

    records = run_prediction_matrix(groups, checkpoints, predict_one,
                                    one_to_one=args.one_to_one,
                                    ensemble=args.ensemble)
    legacy = (not args.checkpoint and args.ensemble is None
              and not args.one_to_one and len(groups) == 1)
    out = records[0]["predictions"] if legacy else records
    with open(args.output_path, "w") as f:
        json.dump(out, f)
    print(json.dumps(out))
