"""
Host-side mapping of scalar class labels.

The port's own copy of ``label_operator`` from
``adell_mri_tpu/transforms/labels.py``, its "cat" and group mappings
(the classification transforms binarize by ``positive_labels``
themselves).
"""

from typing import Optional, Sequence


def label_operator(
    value,
    possible_labels: Sequence,
    label_groups: Optional[Sequence[Sequence]] = None,
) -> int:
    """``label_groups`` maps each group's members to the group's index;
    otherwise ``possible_labels`` map to 0..n-1. Values compare as
    strings; a list value takes its maximum."""
    if isinstance(value, (tuple, list)):
        value = max(value)
    if label_groups is not None:
        match = {
            str(label): i
            for i, group in enumerate(label_groups)
            for label in group
        }
    else:
        match = {str(v): i for i, v in enumerate(possible_labels)}
    return match[str(value)]
