"""
The port's copies of the JAX package's numpy modules for prediction:
``AdaptivePredictionSets`` and ``entrypoints/prediction_utils.py``.

``AdaptivePredictionSets`` calibrates the same ``q_hat`` and gives the
same sets as the JAX one, exactly, on hypothesis-drawn probabilities,
labels and levels. ``get_ensemble_prediction`` and
``run_prediction_matrix`` give the JAX records exactly on the same
per-case values (every checkpoint a group, ``one_to_one``, both
ensembles, scalar and per-class predictions), and refuse what the JAX
ones refuse; ``manager_for_checkpoint_path`` parses the same run
directories.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from adell_mri_tpu.entrypoints import prediction_utils as jpu
from adell_mri_tpu.models.layers.conformal import (
    AdaptivePredictionSets as JaxAPS,
)
from adell_mri_torch.entrypoints import prediction_utils as tpu
from adell_mri_torch.models.layers.conformal import AdaptivePredictionSets


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 40), c=st.integers(2, 6),
       alpha=st.sampled_from([0.05, 0.1, 0.2, 0.5]),
       seed=st.integers(0, 2**31 - 1), ties=st.booleans())
def test_prediction_sets_match_jax(n, c, alpha, seed, ties):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, c)) * 2
    if ties:
        logits = np.round(logits)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    probs = probs.astype(np.float32)
    labels = rng.integers(0, c, n)
    want = JaxAPS(alpha).calibrate(probs, labels)
    got = AdaptivePredictionSets(alpha).calibrate(probs, labels)
    assert got.q_hat == want.q_hat
    test = probs[::-1].copy()
    np.testing.assert_array_equal(got(test), want(test))
    # some class of each row's top probability is in its set (with ties
    # that need not be the one argmax picks)
    top = test == test.max(1, keepdims=True)
    assert (got(test) & top).any(1).all()


def test_prediction_sets_need_calibration():
    with pytest.raises(RuntimeError, match="calibrate"):
        AdaptivePredictionSets()(np.ones((1, 2)) / 2)


def _value(kind):
    def predict_one(variables, pid, label):
        base = variables["w"] * (1 + int(pid.split("_")[1]))
        return base if kind == "scalar" else [base, 1 - base, 0.25 * base]

    return predict_one


@pytest.mark.parametrize("kind", ["scalar", "classes"])
@pytest.mark.parametrize("one_to_one, ensemble", [
    (False, None), (True, None), (False, "mean"), (True, "median"),
    (False, "median")])
def test_prediction_matrix_matches_jax(kind, one_to_one, ensemble):
    groups = [["case_0", "case_1"], ["case_2", "case_1", "case_3"]]
    checkpoints = [("a/cls_fold0", {"w": 0.1}), ("b/cls_fold1", {"w": 0.3}),
                   ("c/cls_fold2", {"w": 0.2})]
    args = dict(one_to_one=one_to_one, ensemble=ensemble)
    want = jpu.run_prediction_matrix(groups, checkpoints, _value(kind),
                                     **args)
    got = tpu.run_prediction_matrix(groups, checkpoints, _value(kind),
                                    **args)
    assert got == want


def test_prediction_matrix_refusals_match_jax():
    groups = [["case_0"], ["case_1"]]
    checkpoints = [("a/cls_fold0", {"w": 0.1})]
    for mod in (jpu, tpu):
        with pytest.raises(ValueError, match="one checkpoint per"):
            mod.run_prediction_matrix(groups, checkpoints, _value("scalar"),
                                      one_to_one=True)
        with pytest.raises(ValueError, match="mean|median"):
            mod.get_ensemble_prediction([], "max")


@pytest.mark.parametrize("path", ["runs/cls_fold3", "runs/cls_fold0/",
                                  "a_b_fold12"])
def test_manager_for_checkpoint_path_matches_jax(tmp_path, path):
    full = str(tmp_path / path)
    assert tpu.manager_for_checkpoint_path(full).dir == \
        jpu.manager_for_checkpoint_path(full).dir
    with pytest.raises(ValueError, match="_fold"):
        tpu.manager_for_checkpoint_path(str(tmp_path / "runs"))
