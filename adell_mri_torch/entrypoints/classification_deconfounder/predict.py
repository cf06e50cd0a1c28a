"""
``python -m adell_mri_torch classification_deconfounder predict``.

Counterpart of ``adell_mri_tpu/entrypoints/classification_deconfounder/
predict.py``: per case, the probability (the sigmoid, or the softmax
above two classes; ``--prediction_type logit`` the logits) of the
``DeconfoundedNet`` rebuilt as ``test`` rebuilds it, with the surrogate
heads' predictions beside it (``{"prediction", "cat_surrogates": the
argmax of each categorical head, "cont_surrogates"}``) unless
``--exclude_surrogate_variables`` or ``--ensemble`` is given or the model
has no surrogate head. Every ``--checkpoint`` serves every
``--prediction_ids`` group, or with ``--one_to_one`` checkpoint ``i``
group ``i``; ``--ensemble mean|median`` appends the aggregate of the
predictions (``entrypoints/prediction_utils.py``). One checkpoint, one
group and neither ``--one_to_one`` nor ``--ensemble`` write the
``{id: prediction}`` map alone, anything else the records. A case
without a label gets the first label the mapping accepts.
"""

import json

import numpy as np
import torch

from adell_mri_torch.data import Dataset
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.entrypoints.classification_deconfounder.test import (
    rebuild,
)
from adell_mri_torch.entrypoints.prediction_utils import (
    prediction_id_groups,
    resolve_checkpoint_variables,
    run_prediction_matrix,
    sample_cache_is_reused,
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
    "exclude_surrogate_variables",
    "dev",
    "precision",
    "seed",
]


def main(arguments):
    parser = Parser(prog="adell classification_deconfounder predict")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    dec = rebuild(args)
    checkpoints = [(label, dec.weights(state)) for label, state in
                   resolve_checkpoint_variables(args.checkpoint, dec.manager)]
    label_key = dec.t_args.get("label_key", "label")
    load_fn = dec.transforms.load_fn()
    groups_of_labels = dec.t_args.get("label_groups")
    possible = dec.t_args.get("possible_labels")
    placeholder = (groups_of_labels[0][0] if groups_of_labels
                   else possible[0] if possible else 0)
    # the ensemble aggregates the prediction alone
    with_surrogates = (not args.exclude_surrogate_variables
                       and args.ensemble is None)

    data = Dataset(args.dataset_json)
    groups = prediction_id_groups(args.prediction_ids, data)
    cache_reused = sample_cache_is_reused(groups, len(checkpoints),
                                          args.one_to_one)
    cache = {}

    def predict_one(weights, pid, label):
        if pid in cache:
            sample = cache[pid]
        else:
            entry = {**data[pid], "identifier": pid}
            entry.setdefault(label_key, placeholder)
            sample = load_fn(entry)
            if cache_reused:
                cache[pid] = sample
        logits, cat_preds, cont_pred = dec.forward(weights, sample["image"])
        if args.prediction_type == "logit":
            pred = logits.tolist()
        elif dec.n_classes == 2:
            pred = float(torch.sigmoid(logits[0]))
        else:
            pred = torch.softmax(logits, -1).tolist()
        if not with_surrogates or (not cat_preds and cont_pred is None):
            return pred
        return {
            "prediction": pred,
            "cat_surrogates": [int(np.argmax(c.numpy())) for c in cat_preds],
            "cont_surrogates": (None if cont_pred is None
                                else cont_pred.tolist()),
        }

    records = run_prediction_matrix(groups, checkpoints, predict_one,
                                    one_to_one=args.one_to_one,
                                    ensemble=args.ensemble)
    legacy = (not args.checkpoint and args.ensemble is None
              and not args.one_to_one and len(groups) == 1)
    out = records[0]["predictions"] if legacy else records
    with open(args.output_path, "w") as f:
        json.dump(out, f)
    print(json.dumps(out))
