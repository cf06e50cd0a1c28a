"""
Several checkpoints in the classification ``test`` and ``predict`` entry
points.

The port's own copy of ``adell_mri_tpu/entrypoints/prediction_utils.py``
(numpy, no JAX), with the records of the JAX package's schema: one
``{"iteration", "prediction_ids", "checkpoint", "predictions"}`` record
for each pair of a ``--prediction_ids`` group and a checkpoint, or with
``--one_to_one`` checkpoint ``i`` for group ``i`` alone, and with
``--ensemble mean|median`` an appended ``{"iteration": 0,
"prediction_ids", "checkpoint": "ensemble", "predictions",
"n_predictions"}`` record. A checkpoint's "variables" are the port's
state dict (``model.pt``: parameters, running statistics and a GP
head's random features).
"""

import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from adell_mri_torch.data.dataset import parse_ids
from adell_mri_torch.train.checkpoints import CheckpointManager


def get_ensemble_prediction(
    output: List[Dict[str, Any]], ensemble_type: str
) -> Dict[str, Any]:
    """One record aggregating the per-checkpoint records ``output``: the
    elementwise mean or median (f64) of each ID's predictions (a scalar
    stays a float, a list a list), with ``n_predictions`` of each ID."""
    if ensemble_type not in ("mean", "median"):
        raise ValueError(
            f"Unknown ensemble type {ensemble_type!r} (mean|median)")
    ens: Dict[str, Any] = {
        "iteration": 0,
        "prediction_ids": [],
        "checkpoint": "ensemble",
        "predictions": {},
        "n_predictions": {},
    }
    stacks: Dict[str, List[np.ndarray]] = {}
    for record in output:
        for k, v in record["predictions"].items():
            stacks.setdefault(k, []).append(np.asarray(v, dtype=np.float64))
    ens["prediction_ids"] = sorted(stacks)
    for k, vals in stacks.items():
        arr = np.stack(vals, axis=0)
        agg = arr.mean(0) if ensemble_type == "mean" else np.median(arr, 0)
        ens["predictions"][k] = float(agg) if agg.ndim == 0 else agg.tolist()
        ens["n_predictions"][k] = len(vals)
    return ens


def sample_cache_is_reused(groups: Sequence[Sequence[str]],
                           n_checkpoints: int, one_to_one: bool) -> bool:
    """True when a case's loaded sample would serve more than once:
    several checkpoints for each group, or an ID in several groups (one
    checkpoint over one group would only hold every volume in memory)."""
    if not one_to_one and n_checkpoints > 1:
        return True
    all_pids = [pid for g in groups for pid in g]
    return len(set(all_pids)) < len(all_pids)


def manager_for_checkpoint_path(path: str) -> CheckpointManager:
    """The manager of a ``--checkpoint`` entry: a run directory
    ``{root}/{name}_fold{k}`` (a trailing slash is allowed)."""
    path = os.path.abspath(path.rstrip("/"))
    m = re.match(r"^(?P<name>.+)_fold(?P<fold>\d+)$", os.path.basename(path))
    if m is None:
        raise ValueError(
            f"--checkpoint entry {path!r} must point at a run directory "
            "named <name>_fold<k>")
    return CheckpointManager(os.path.dirname(path), name=m.group("name"),
                             fold=int(m.group("fold")))


def resolve_checkpoint_variables(
    checkpoint_paths: Optional[Sequence[str]],
    default_manager: CheckpointManager,
) -> List[Tuple[str, Dict[str, Any]]]:
    """``[(label, state_dict), ...]``: one entry per ``--checkpoint``
    path, labelled by the path as given, or the default manager's weights
    labelled by its directory when there is none."""
    if checkpoint_paths:
        return [(path, manager_for_checkpoint_path(path).load_state_dict())
                for path in checkpoint_paths]
    return [(default_manager.dir, default_manager.load_state_dict())]


def prediction_id_groups(prediction_ids: Optional[Sequence[str]],
                         data) -> List[List[str]]:
    """``--prediction_ids`` (or ``--test_ids``) as groups: each entry is
    a comma-separated list or a file of IDs (``parse_ids``); none means
    one group of every ID. IDs outside ``data`` are dropped."""
    if prediction_ids:
        groups = parse_ids(list(prediction_ids), "nested_list")
    else:
        groups = [list(data.keys())]
    return [[pid for pid in g if pid in data.dataset] for g in groups]


def run_prediction_matrix(
    groups: List[List[str]],
    checkpoints: List[Tuple[str, Dict[str, Any]]],
    predict_one: Callable[[Dict[str, Any], str, str], Any],
    one_to_one: bool = False,
    ensemble: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """The records of ``predict_one(variables, pid, label)`` over the
    groups and the checkpoints: every checkpoint for every group, or with
    ``one_to_one`` (and no ensemble) checkpoint ``i`` for group ``i``;
    with ``ensemble`` the aggregate record last."""
    if one_to_one and ensemble is None and len(checkpoints) < len(groups):
        raise ValueError(
            f"--one_to_one needs one checkpoint per prediction-id group "
            f"({len(groups)}), got {len(checkpoints)}")
    global_output: List[Dict[str, Any]] = []
    for iteration, group in enumerate(groups):
        if one_to_one and ensemble is None:
            ckpt_list = [checkpoints[iteration]]
        else:
            ckpt_list = checkpoints
        for label, variables in ckpt_list:
            global_output.append({
                "iteration": iteration,
                "prediction_ids": list(group),
                "checkpoint": label,
                "predictions": {pid: predict_one(variables, pid, label)
                                for pid in group},
            })
    if ensemble is not None:
        global_output.append(get_ensemble_prediction(global_output, ensemble))
    return global_output
