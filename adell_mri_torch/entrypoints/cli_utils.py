"""
Helpers of the entry points.

The port's own copy of ``derive_n_classes``, ``filter_training_pids``,
``parse_label_groups`` and ``stratification_labels`` from
``adell_mri_tpu/entrypoints/cli_utils.py``.
"""

import logging
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def parse_label_groups(label_groups):
    """``--label_groups "0,1" "2,3"`` -> [["0", "1"], ["2", "3"]]."""
    if not label_groups:
        return None
    return [g.split(",") if isinstance(g, str) else list(g)
            for g in label_groups]


def stratification_labels(data, pids, label_key, n_folds, explicit_folds):
    """The class labels (as strings) that stratify the folds, or None:
    with explicit folds or ``n_folds <= 1``, when an ID lacks the label,
    or when the rarest class has fewer members than ``n_folds`` (then the
    folds are unstratified, with a warning)."""
    if n_folds <= 1 or explicit_folds:
        return None
    try:
        labels = [str(data[p][label_key]) for p in pids]
    except (KeyError, TypeError):
        logger.warning("cannot stratify folds: some ids lack the label key "
                       "%r; falling back to unstratified folds", label_key)
        return None
    if not labels:
        return None
    smallest = min(Counter(labels).values())
    if smallest < n_folds:
        logger.warning("cannot stratify folds: the rarest class has %d "
                       "member(s) < n_folds=%d; falling back to "
                       "unstratified folds", smallest, n_folds)
        return None
    return labels


def derive_n_classes(args) -> int:
    """The class count from the label flags, in this precedence:
    ``--label_groups`` (a class per group), ``--positive_labels``
    (binary), ``--possible_labels`` (a class per value), else
    ``--n_classes``. An explicit ``--n_classes`` other than 2 that
    contradicts the derived count raises."""
    lg = getattr(args, "label_groups", None)
    pos = getattr(args, "positive_labels", None)
    pl = getattr(args, "possible_labels", None)
    if lg:
        derived = len(lg)
    elif pos:
        derived = 2
    elif pl:
        derived = len(pl)
    else:
        return getattr(args, "n_classes", 2) or 2
    explicit = getattr(args, "n_classes", None)
    if explicit not in (None, 2, derived):
        raise ValueError(
            f"--n_classes {explicit} contradicts the label flags "
            f"({derived} classes derived from "
            "label_groups/positive_labels/possible_labels)"
        )
    return derived


def filter_training_pids(
    train_pids: Sequence[str],
    excluded: Optional[Sequence[str]] = None,
    subsample_fraction: Optional[float] = None,
    seed: int = 42,
    fold_idx: int = 0,
) -> List[str]:
    """The training split without ``excluded`` IDs, then a
    ``subsample_fraction`` share of it (at least one) drawn with a numpy
    generator seeded with ``seed + fold_idx``, in the split's order
    (learning curves)."""
    train_pids = list(train_pids)
    if excluded:
        excl = set(excluded)
        train_pids = [p for p in train_pids if p not in excl]
    if subsample_fraction is not None:
        rng = np.random.default_rng(seed + fold_idx)
        n_keep = max(1, int(len(train_pids) * subsample_fraction))
        train_pids = [
            train_pids[i]
            for i in sorted(rng.choice(len(train_pids), size=n_keep,
                                       replace=False))
        ]
    return train_pids
