"""
Lesion-level evaluation in the PI-CAI style, in numpy and scipy.

The port's own copy of ``adell_mri_tpu/eval/lesion.py``:
``extract_lesion_candidates`` (static, ``dynamic`` and ``dynamic-fast``
thresholds over 26-connected components), ``evaluate_case`` (candidates
matched to ground-truth lesions by an optimal assignment over their IoU)
and ``evaluate`` (cases in a thread pool), whose ``Metrics`` give the
lesion-level average precision, the case-level AUROC and their mean, the
PI-CAI score.
"""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage
from scipy.optimize import linear_sum_assignment

from adell_mri_torch.eval.metrics import precision_recall_curve, roc_auc

_STRUCT = np.ones((3, 3, 3))


def _structure(ndim: int) -> np.ndarray:
    """26-connectivity (8 in 2D)."""
    return _STRUCT[tuple(slice(None) if d < ndim else 1 for d in range(3))]


def _component_maxima(x: np.ndarray, labels: np.ndarray, n: int):
    """[n + 1] maxima of ``x`` over each label 1..n (entry 0 and labels
    with no voxel: 0), in ``x``'s dtype, from one pass."""
    out = np.full(n + 1, -np.inf, x.dtype)
    inside = labels > 0
    np.maximum.at(out, labels[inside], x[inside])
    out[~np.isfinite(out)] = 0
    return out


def _components(softmax: np.ndarray, threshold, min_voxels: int,
                max_prob_round_decimals):
    """The components of ``softmax`` at or above ``threshold`` (values
    below it cleared, 26-connected): ``(clipped, labels, values, keep)``,
    with each component's maximum (at least the 0 around it; rounded when
    asked) and whether it has more than ``min_voxels`` voxels. Counts and
    maxima come from one pass over the volume, however many components
    there are."""
    clipped = softmax.copy()
    clipped[softmax < threshold] = 0
    labels, n = ndimage.label(clipped, structure=_structure(softmax.ndim))
    counts = np.bincount(labels.ravel(), minlength=n + 1)
    keep = counts > min_voxels
    keep[0] = False
    values = _component_maxima(clipped, labels, n)
    values[1:] = np.where(counts[1:] < softmax.size,
                          np.maximum(values[1:], 0), values[1:])
    if max_prob_round_decimals is not None:
        values = np.round(values, max_prob_round_decimals)
    return clipped, labels, values, keep


def _extract_static(
    softmax: np.ndarray,
    threshold: float,
    min_voxels_detection: int,
    max_prob_round_decimals,
) -> Tuple[np.ndarray, List[Tuple[int, float]], np.ndarray]:
    """Values below ``threshold`` cleared, components labelled, those of
    ``min_voxels_detection`` voxels or fewer removed; each remaining
    component takes its maximum (at least the 0 around it)."""
    clipped, blobs_index, values, keep = _components(
        softmax, threshold, min_voxels_detection, max_prob_round_decimals
    )
    small = ~keep
    small[0] = False
    blobs_index[small[blobs_index]] = 0
    in_blob = keep[blobs_index]
    all_hard_blobs = np.zeros_like(softmax)
    all_hard_blobs[in_blob] = np.where(
        clipped[in_blob] > 0, values[blobs_index[in_blob]], clipped[in_blob]
    )
    confidences = [(int(i), float(values[i])) for i in np.flatnonzero(keep)]
    return all_hard_blobs, confidences, blobs_index


def extract_lesion_candidates(
    softmax: np.ndarray,
    threshold="dynamic-fast",
    min_voxels: int = 10,
    max_prob_round_decimals=None,
    num_lesions_to_extract: int = 5,
    dynamic_threshold_factor: float = 2.5,
    remove_adjacent_lesion_candidates: bool = True,
) -> Tuple[np.ndarray, List[Tuple[int, float]], np.ndarray]:
    """Lesion candidates of a probability map: ``(all_hard_blobs,
    [(index, confidence)], indexed_pred)``. ``dynamic`` takes, until
    ``num_lesions_to_extract`` are found, the blob of the global maximum
    at threshold max / ``dynamic_threshold_factor``, skips it when it
    touches one already taken, and clears it; ``dynamic-fast`` is one
    static pass at that threshold; a number is a static threshold."""
    softmax = np.asarray(softmax, np.float32)

    if threshold == "dynamic":
        return _extract_dynamic(
            softmax, min_voxels, max_prob_round_decimals,
            num_lesions_to_extract, dynamic_threshold_factor,
            remove_adjacent_lesion_candidates,
        )
    if threshold == "dynamic-fast":
        threshold = float(np.max(softmax) / dynamic_threshold_factor)
    return _extract_static(
        softmax, float(threshold), min_voxels, max_prob_round_decimals
    )


def _seed_component(working: np.ndarray, thr, seed):
    """The 26-connected component of ``working``'s voxels at or above
    ``thr`` (and nonzero) that holds ``seed``: ``(box, mask in the box)``.
    A box around the seed is labelled, and doubled while the component
    reaches one of its faces inside the volume."""
    struct = _structure(working.ndim)
    shape = working.shape
    r = 8
    while True:
        box = tuple(slice(max(c - r, 0), min(c + r + 1, s))
                    for c, s in zip(seed, shape))
        sub = working[box]
        lab, _ = ndimage.label(~(sub < thr) & (sub != 0), structure=struct)
        comp = lab == lab[tuple(c - b.start for c, b in zip(seed, box))]
        open_face = any(
            (b.start > 0 and comp.take(0, axis=d).any())
            or (b.stop < s and comp.take(-1, axis=d).any())
            for d, (b, s) in enumerate(zip(box, shape))
        )
        if not open_face:
            return box, comp
        r *= 2


def _extract_dynamic(
    softmax: np.ndarray,
    min_voxels: int,
    max_prob_round_decimals,
    num_lesions_to_extract: int,
    dynamic_threshold_factor: float,
    remove_adjacent_lesion_candidates: bool,
):
    """The ``dynamic`` threshold. A step takes the candidate of the global
    maximum: the component of its voxel, found by labelling around it,
    where that component is kept and holds the only voxel of that value
    (and nothing is rounded); else the kept component of the largest
    maximum (the first in raster order among equals) from a labelling of
    the whole volume, which the next step reuses while the threshold
    stays the same (clearing one component leaves the others as they
    were). Either way the steps are those of labelling the whole volume
    every time."""
    struct = _structure(softmax.ndim)
    shape = softmax.shape
    working = softmax.copy()
    dynamic_hard_blobs = np.zeros_like(softmax)
    confidences: List[Tuple[int, float]] = []
    dynamic_indexed = np.zeros_like(softmax, dtype=np.int32)
    cache = None  # (threshold, labels, values, keep, boxes)
    while len(confidences) < num_lesions_to_extract:
        tumor_index = 1 + len(confidences)
        seed = np.unravel_index(np.argmax(working), shape)
        max_prob = working[seed]
        if max_prob < 0.01:
            break
        thr = max_prob / dynamic_threshold_factor
        fast = max_prob_round_decimals is None and np.isfinite(max_prob)
        if fast:
            box, mask = _seed_component(working, thr, seed)
            fast = (np.count_nonzero(mask) > min_voxels
                    and np.count_nonzero(working == max_prob)
                    == np.count_nonzero(working[box][mask] == max_prob))
        if fast:
            cache = None
        else:
            if cache is None or cache[0] != thr:
                _, labels, values, keep = _components(
                    working, thr, min_voxels, max_prob_round_decimals)
                cache = (thr, labels, values, keep,
                         ndimage.find_objects(labels))
            _, labels, values, keep, boxes = cache
            if not keep.any():
                break
            max_prob = values[keep].max()
            if max_prob <= 0.0:
                break
            cid = int(np.flatnonzero(keep & (values == max_prob))[0])
            keep[cid] = False
            box = boxes[cid - 1]
            mask = labels[box] == cid
        # does the blob touch one already taken? Its dilation meets them
        # (the structure is symmetric), within its box grown by one voxel
        grown = tuple(slice(max(b.start - 1, 0), min(b.stop + 1, n))
                      for b, n in zip(box, shape))
        inner = tuple(slice(b.start - g.start, b.stop - g.start)
                      for b, g in zip(box, grown))
        mask_grown = np.zeros([g.stop - g.start for g in grown], bool)
        mask_grown[inner] = mask
        has_overlap = (
            ndimage.binary_dilation(mask_grown, structure=struct)
            & (dynamic_hard_blobs[grown] > 0)
        ).any()
        if not (remove_adjacent_lesion_candidates and has_overlap):
            dynamic_hard_blobs[box][mask] += max_prob
            confidences.append((tumor_index, float(max_prob)))
            dynamic_indexed[box][mask] += tumor_index
        working[box][mask] = 0
    return dynamic_hard_blobs, confidences, dynamic_indexed


def evaluate_case(
    y_det: np.ndarray,
    y_true: np.ndarray,
    min_overlap: float = 0.10,
    y_det_postprocess_func=None,
) -> Tuple[List[Tuple[int, float]], float]:
    """One case: ``(lesion_results, case_confidence)``, where
    ``lesion_results`` holds ``(is_lesion, confidence)`` for each
    ground-truth lesion (confidence 0 when missed) and each unmatched
    candidate. Candidates are the 26-connected components of ``y_det``
    (after ``y_det_postprocess_func``) with their maxima; they are matched
    to lesions by an optimal assignment that first maximises the number of
    pairs over ``min_overlap`` IoU, then their overlap. An unmatched
    candidate that still overlaps a lesion above ``min_overlap`` is not a
    false positive."""
    if y_det_postprocess_func is not None:
        y_det = y_det_postprocess_func(y_det)
    y_det = np.asarray(y_det, np.float32)
    struct = _structure(y_det.ndim)
    indexed_pred, n_cand = ndimage.label(y_det > 0, structure=struct)
    maxima = _component_maxima(y_det, indexed_pred, n_cand)
    confidences = [
        (cand_id, float(maxima[cand_id])) for cand_id in range(1, n_cand + 1)
    ]

    y_true = np.asarray(y_true) > 0.5
    gt_labels, n_gt = ndimage.label(y_true, structure=struct)
    lesion_results: List[Tuple[int, float]] = []
    matched_candidates = set()

    if n_gt > 0 and confidences:
        # every (lesion, candidate) intersection from one pass
        both = (gt_labels > 0) & (indexed_pred > 0)
        pair = (gt_labels[both].astype(np.int64) - 1) * n_cand + (
            indexed_pred[both] - 1)
        inter = np.bincount(pair, minlength=n_gt * n_cand).reshape(
            n_gt, n_cand)
        gt_size = np.bincount(gt_labels.ravel(), minlength=n_gt + 1)[1:]
        cand_size = np.bincount(indexed_pred.ravel(),
                                minlength=n_cand + 1)[1:]
        union = gt_size[:, None] + cand_size[None, :] - inter
        iou = inter / union
        iou[iou < min_overlap] = 0.0
        iou[iou > 0] += 1.0
        rows, cols = linear_sum_assignment(iou, maximize=True)
        assigned = {}
        for i, j in zip(rows, cols):
            if iou[i, j] > 0:
                assigned[i] = j
                matched_candidates.add(confidences[j][0])
        for i in range(n_gt):
            if i in assigned:
                lesion_results.append((1, confidences[assigned[i]][1]))
            else:
                lesion_results.append((1, 0.0))
        for j, (cand_id, _) in enumerate(confidences):
            if (iou[:, j] > 0).any():
                matched_candidates.add(cand_id)
    else:
        lesion_results.extend((1, 0.0) for _ in range(n_gt))
    for cand_id, conf in confidences:
        if cand_id not in matched_candidates:
            lesion_results.append((0, conf))

    case_conf = max((c for _, c in confidences), default=0.0)
    return lesion_results, case_conf


@dataclass
class Metrics:
    """Lesion-level average precision (``AP``), case-level ``auroc`` and
    their mean (``score``) over the cases of one evaluation."""

    lesion_results: Dict[str, List[Tuple[int, float]]] = field(
        default_factory=dict
    )
    case_pred: Dict[str, float] = field(default_factory=dict)
    case_target: Dict[str, int] = field(default_factory=dict)

    @property
    def AP(self) -> float:
        flat = [r for rs in self.lesion_results.values() for r in rs]
        if not flat or not any(is_l for is_l, _ in flat):
            return float("nan")
        y = np.asarray([is_l for is_l, _ in flat])
        p = np.asarray([conf for _, conf in flat])
        precision, recall, thresholds = precision_recall_curve(y, p)
        # missed lesions enter at confidence 0: they count for recall and
        # take no precision
        precision[:-1][thresholds == 0] = 0
        return float(-np.sum(np.diff(recall) * precision[:-1]))

    @property
    def auroc(self) -> float:
        y = np.asarray(list(self.case_target.values()))
        p = np.asarray(list(self.case_pred.values()))
        return roc_auc(y, p)

    @property
    def score(self) -> float:
        return float(np.nanmean([self.AP, self.auroc]))


def evaluate(
    y_det: Sequence[np.ndarray],
    y_true: Sequence[np.ndarray],
    subject_list: Optional[Sequence[str]] = None,
    min_overlap: float = 0.10,
    y_det_postprocess_func=None,
    num_parallel_calls: int = 4,
) -> Metrics:
    """``evaluate_case`` over the cases in a thread pool."""
    if subject_list is None:
        subject_list = [str(i) for i in range(len(y_det))]
    m = Metrics()

    def run_one(args):
        sid, det, true = args
        lesion_results, case_conf = evaluate_case(
            det, true, min_overlap, y_det_postprocess_func
        )
        return sid, lesion_results, case_conf, int(np.any(true > 0.5))

    with ThreadPoolExecutor(max_workers=num_parallel_calls) as pool:
        for sid, lr, conf, target in pool.map(
            run_one, zip(subject_list, y_det, y_true)
        ):
            m.lesion_results[sid] = lr
            m.case_pred[sid] = conf
            m.case_target[sid] = target
    return m
