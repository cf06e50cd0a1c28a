"""
The port's evaluation (``adell_mri_torch/eval``) against the JAX
package's on the same numpy inputs: voxel and classification metrics
within 1e-6 (the JAX side takes precision, recall, F1 and AUC from
scikit-learn, the port computes them in numpy), lesion candidates
bit-equal, and the PI-CAI metrics (AP, AUROC, score) within 1e-6 on
seeded multi-blob cases with a missed lesion and an empty case.
"""

import numpy as np
import pytest

from adell_mri_tpu.eval import lesion as jlesion
from adell_mri_tpu.eval import metrics as jmetrics
from adell_mri_torch.eval import lesion as tlesion
from adell_mri_torch.eval import metrics as tmetrics

TOL = 1e-6


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dice_iou_match_jax(seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(size=(16, 16, 16)).astype(np.float32)
    target = (rng.uniform(size=(16, 16, 16)) > 0.7).astype(np.float32)
    for thr in (0.3, 0.5, 0.9):
        assert abs(tmetrics.dice_score(pred, target, thr)
                   - jmetrics.dice_score(pred, target, thr)) <= TOL
        assert abs(tmetrics.iou_score(pred, target, thr)
                   - jmetrics.iou_score(pred, target, thr)) <= TOL
    empty = np.zeros((4, 4, 4))
    assert tmetrics.dice_score(empty, empty) == 1.0
    assert tmetrics.iou_score(empty, empty) == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_binary_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 200
    target = (rng.uniform(size=n) > 0.6).astype(np.float32)
    # ties and saturated values, as a sigmoid gives them
    pred = np.clip(np.round(0.5 * target + rng.uniform(size=n) * 0.7, 2),
                   0, 1)
    for thr in (0.2, 0.5):
        _close(tmetrics.binary_metrics(pred, target, thr),
               jmetrics.binary_metrics(pred, target, thr))


def test_binary_metrics_one_class_match_jax():
    pred = np.linspace(0, 1, 20)
    target = np.zeros(20)
    _close(tmetrics.binary_metrics(pred, target),
           jmetrics.binary_metrics(pred, target))


@pytest.mark.parametrize("nc,seed", [(3, 0), (4, 1), (5, 2)])
def test_multiclass_metrics_match_jax(nc, seed):
    rng = np.random.default_rng(seed)
    n = 150
    target = rng.integers(0, nc, size=n)
    logits = rng.normal(size=(n, nc)) + 1.5 * np.eye(nc)[target]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    _close(tmetrics.multiclass_metrics(probs, target),
           jmetrics.multiclass_metrics(probs, target))
    # a class that never occurs: its AUC is undefined
    absent = np.where(target == nc - 1, 0, target)
    _close(tmetrics.multiclass_metrics(probs, absent),
           jmetrics.multiclass_metrics(probs, absent))


@pytest.mark.parametrize("nc", [2, 3, 4])
def test_segmentation_class_metrics_match_jax(nc):
    rng = np.random.default_rng(nc)
    pred = rng.integers(0, nc, size=(16, 16, 16))
    target = rng.integers(0, nc, size=(16, 16, 16))
    _close(tmetrics.segmentation_class_metrics(pred, target, nc),
           jmetrics.segmentation_class_metrics(pred, target, nc))


def test_auc_and_ece_match_jax():
    rng = np.random.default_rng(5)
    target = (rng.uniform(size=300) > 0.5).astype(int)
    pred = np.clip(0.3 * target + rng.uniform(size=300) * 0.8, 0, 1)
    assert abs(tmetrics.auc_score(pred, target)
               - jmetrics.auc_score(pred, target)) <= TOL
    assert abs(tmetrics.expected_calibration_error(pred, target)
               - jmetrics.expected_calibration_error(pred, target)) <= TOL
    assert np.isnan(tmetrics.auc_score(pred, np.ones(300)))


def _blob(shape, centre, radius):
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                indexing="ij"), -1)
    return (((grid - np.asarray(centre)) ** 2).sum(-1) <= radius ** 2)


def _case(seed, n_lesions, miss=False, empty=False, shape=(16, 16, 16)):
    """A seeded case: lesions as balls, a probability map with a peak on
    each lesion (none on the last one when ``miss``), a false-positive
    peak and background noise."""
    rng = np.random.default_rng(seed)
    label = np.zeros(shape, np.float32)
    prob = rng.uniform(0, 0.05, size=shape).astype(np.float32)
    centres = [(4, 4, 4), (11, 11, 11), (4, 11, 8), (11, 4, 6)]
    for i in range(n_lesions):
        c = centres[i]
        label[_blob(shape, c, 2.5)] = 1.0
        if miss and i == n_lesions - 1:
            continue
        off = rng.integers(-1, 2, size=3)
        peak = rng.uniform(0.4, 0.95)
        ball = _blob(shape, np.asarray(c) + off, 2.5)
        prob[ball] = np.maximum(prob[ball], peak * rng.uniform(
            0.6, 1.0, size=ball.sum()))
    if not empty:
        fp = _blob(shape, (8, 2, 13), 2.0)
        prob[fp] = np.maximum(prob[fp], rng.uniform(0.2, 0.6))
    else:
        prob[:] = 0.0
    return prob, label


@pytest.mark.parametrize("threshold", ["dynamic", "dynamic-fast", 0.3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_lesion_candidates_bit_equal(threshold, seed):
    prob, _ = _case(seed, 3)
    got = tlesion.extract_lesion_candidates(prob, threshold=threshold)
    want = jlesion.extract_lesion_candidates(prob, threshold=threshold)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


def _cohort():
    """Five cases: multi-blob, a missed lesion, a lesion-free case with a
    false positive, an empty case (no lesion, no candidate), one lesion."""
    cases = [_case(0, 3), _case(1, 2, miss=True), _case(2, 0),
             _case(3, 0, empty=True), _case(4, 1)]
    return [c[0] for c in cases], [c[1] for c in cases]


@pytest.mark.parametrize("post", ["binary", "candidates"])
def test_evaluate_matches_jax(post):
    preds, labels = _cohort()
    if post == "binary":
        def fn(y):
            return y > 0.1
    else:
        def fn(y):
            return jlesion.extract_lesion_candidates(y)[0]
    got = tlesion.evaluate(preds, labels, y_det_postprocess_func=fn)
    want = jlesion.evaluate(preds, labels, y_det_postprocess_func=fn)
    assert got.lesion_results == want.lesion_results
    assert got.case_pred == want.case_pred
    assert got.case_target == want.case_target
    for name in ("AP", "auroc", "score"):
        g, w = getattr(got, name), getattr(want, name)
        assert np.isfinite(w)
        assert abs(g - w) <= TOL, (name, g, w)
    # a missed lesion enters as (1, 0.0)
    assert (1, 0.0) in got.lesion_results["1"]
    assert got.lesion_results["3"] == []


def test_evaluate_case_matches_jax_per_case():
    preds, labels = _cohort()
    for p, y in zip(preds, labels):
        got = tlesion.evaluate_case(p, y, y_det_postprocess_func=lambda v:
                                    tlesion.extract_lesion_candidates(
                                        v, threshold="dynamic")[0])
        want = jlesion.evaluate_case(p, y, y_det_postprocess_func=lambda v:
                                     jlesion.extract_lesion_candidates(
                                         v, threshold="dynamic")[0])
        assert got == want


def test_metrics_without_lesions_are_nan():
    m = tlesion.Metrics(lesion_results={"a": [(0, 0.3)]},
                        case_pred={"a": 0.3}, case_target={"a": 0})
    jm = jlesion.Metrics(lesion_results={"a": [(0, 0.3)]},
                         case_pred={"a": 0.3}, case_target={"a": 0})
    assert np.isnan(m.AP) and np.isnan(jm.AP)
    assert np.isnan(m.auroc) and np.isnan(jm.auroc)
    assert np.isnan(m.score) == np.isnan(jm.score)


@pytest.mark.parametrize("threshold,min_voxels,offset", [
    (0.6, 0, 0.0), (0.55, 3, 0.0), ("dynamic", 2, 0.0),
    ("dynamic-fast", 1, 0.0), (-0.3, 0, -0.5)])
def test_extract_many_blobs_bit_equal(threshold, min_voxels, offset):
    """A speckled map (hundreds of blobs, negative values with an
    offset): the port's one-pass extraction equals the JAX loop."""
    rng = np.random.default_rng(11)
    prob = (rng.uniform(size=(16, 16, 16)) + offset).astype(np.float32)
    got = tlesion.extract_lesion_candidates(
        prob, threshold=threshold, min_voxels=min_voxels)
    want = jlesion.extract_lesion_candidates(
        prob, threshold=threshold, min_voxels=min_voxels)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


def test_evaluate_case_many_candidates_matches_jax():
    rng = np.random.default_rng(12)
    prob = rng.uniform(size=(16, 16, 16)).astype(np.float32)
    label = (rng.uniform(size=(16, 16, 16)) > 0.85).astype(np.float32)

    def post(y):
        return np.where(y > 0.7, y, 0)

    got = tlesion.evaluate_case(prob, label, y_det_postprocess_func=post)
    want = jlesion.evaluate_case(prob, label, y_det_postprocess_func=post)
    assert len(got[0]) > 20
    assert got == want


def _dynamic_cases():
    """Maps that take each branch of the dynamic extraction: a smooth
    field (the component of the maximum, found around it), a tie between
    two blobs, a maximum in a blob too small to keep, and rounding."""
    rng = np.random.default_rng(13)
    grid = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1)
    smooth = np.zeros((16, 16, 16), np.float32)
    for c, v in (((4, 4, 4), 0.9), ((11, 10, 12), 0.7), ((3, 12, 9), 0.5),
                 ((12, 3, 3), 0.6), ((8, 8, 8), 0.3), ((13, 13, 2), 0.4)):
        d = ((grid - np.asarray(c)) ** 2).sum(-1)
        smooth = np.maximum(smooth, v * np.exp(-d / 6.0)).astype(np.float32)
    smooth += rng.uniform(0, 0.02, smooth.shape).astype(np.float32)
    tie = smooth.copy()
    tie[4, 4, 4] = tie[11, 10, 12] = 0.95
    small = smooth.copy()
    small[14, 1, 14] = 0.99
    return {"smooth": (smooth, {}), "tie": (tie, {}),
            "small": (small, {"min_voxels": 3}),
            "rounded": (smooth, {"max_prob_round_decimals": 1})}


@pytest.mark.parametrize("name", ["smooth", "tie", "small", "rounded"])
def test_dynamic_branches_bit_equal(name):
    prob, kw = _dynamic_cases()[name]
    got = tlesion.extract_lesion_candidates(prob, threshold="dynamic", **kw)
    want = jlesion.extract_lesion_candidates(prob, threshold="dynamic", **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert len(got[1]) >= 2
