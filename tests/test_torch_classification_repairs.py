"""
Two places where the port's classification mode now follows the JAX
package, on the CPU.

- ``ClassificationMetricsCallback``: the JAX callback applies the
  parameters alone, so its batch norms normalize by each validation
  batch's statistics ((0, 1) where a feature has one element to reduce).
  The port's callback gives the same ``V_*`` metrics on a tiny batch-norm
  CatNet with the same weights (1e-5), its running statistics untouched
  and its dropout off.
- ``classification train`` hands ``BatchPreprocessing`` ``--n_classes``,
  as the JAX CLI does, not the class count derived from the label flags.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from adell_mri_tpu.config.factories import (
    get_classification_network as jget_network,
)
from adell_mri_tpu.entrypoints.classification import train as jtrain
from adell_mri_tpu.eval.callbacks import (
    ClassificationMetricsCallback as JaxCallback,
)
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.config.factories import get_classification_network
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.entrypoints.classification import train as ttrain
from adell_mri_torch.eval.callbacks import ClassificationMetricsCallback
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers.adn import batch_stats
from test_torch_unet import random_flax_params

TINY = dict(resnet_structure=[[8, 16, 3, 1], [16, 32, 3, 1]],
            maxpool_structure=[[2, 2, 2], [2, 2, 1]], batch_ensemble=2,
            res_type="resnet", dropout_param=0.2)
SHAPE = (16, 16, 8)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_metrics_callback_uses_batch_statistics_as_jax(n_classes):
    """Two validation batches of 4 and one of 1 (the head's norms then
    have one element a feature: (0, 1) on both sides); running statistics
    far from the batches' own, so a callback on them would differ."""
    rng = np.random.default_rng(20 + n_classes)
    batches = [rng.uniform(size=(b,) + SHAPE + (1,)).astype(np.float32)
               for b in (4, 4, 1)]
    labels = [rng.integers(0, n_classes, size=len(b)).astype(np.float32)
              for b in batches]
    jm = jget_network("cat", TINY, n_classes=n_classes)
    params = jax.tree.map(jnp.asarray, random_flax_params(
        jm, jnp.asarray(batches[0]), seed=21))
    stats = jax.tree.map(
        lambda s: jnp.full(s.shape, 3.0, jnp.float32),
        jm.init(jax.random.PRNGKey(0),
                jnp.asarray(batches[0]))["batch_stats"])
    jcb = JaxCallback(jm, n_classes=n_classes)
    tm = get_classification_network("cat", TINY, n_classes=n_classes)
    tm.load_state_dict(from_flax(params, stats))
    tcb = ClassificationMetricsCallback(tm, n_classes=n_classes)
    tparams = {k: v for k, v in tm.state_dict().items()}
    before = {k: v.clone() for k, v in batch_stats(tm).items()}
    for x, y in zip(batches, labels):
        jcb.on_validation_batch(params, {"image": jnp.asarray(x),
                                         "label": jnp.asarray(y)}, {})
        tcb.on_validation_batch(tparams, {"image": torch.from_numpy(x),
                                          "label": torch.from_numpy(y)}, {})
    # the kept probabilities, then the metrics
    got, want = np.stack(tcb._probs), np.stack(jcb._probs)
    assert np.abs(got - want).max() <= 1e-5
    want_m, got_m = jcb.on_validation_end(params), tcb.on_validation_end(
        tparams)
    assert set(got_m) == set(want_m) and len(want_m) > 3
    for k in want_m:
        assert abs(got_m[k] - want_m[k]) <= 1e-5, k
    for k, v in batch_stats(tm).items():
        assert torch.equal(v, before[k]), k
    assert not tm.training
    # off the callback, eval normalizes by the running statistics again
    with torch.no_grad():
        run = tm(torch.from_numpy(batches[0]))
    want_run = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(batches[0]))
    assert np.abs(run.numpy() - np.asarray(want_run)).max() <= 1e-4 * max(
        1.0, float(np.abs(np.asarray(want_run)).max()))


@pytest.fixture(scope="module")
def grades(tmp_path_factory):
    root = tmp_path_factory.mktemp("grade_cohort")
    rng = np.random.default_rng(0)
    ds = {}
    for i, grade in enumerate(["a", "b", "c", "a", "c", "b"]):
        path = str(root / f"case_{i}_T2.nii.gz")
        tnifti.write_nifti(path, rng.normal(size=SHAPE).astype(np.float32),
                           np.diag([-1.0, -1.0, 2.0, 1.0]))
        ds[f"case_{i}"] = {"T2": path, "grade": grade}
    (root / "ds.json").write_text(json.dumps(ds))
    (root / "cat.yaml").write_text(yaml.safe_dump(
        {**TINY, "learning_rate": 0.01, "batch_size": 2}))
    return root


class _Stop(Exception):
    pass


@pytest.mark.parametrize("extra", [[], ["--n_classes", "3"]])
def test_batch_preprocessing_gets_n_classes_as_jax(grades, monkeypatch,
                                                   extra):
    """``--label_keys grade --possible_labels a b c`` with mixup and label
    smoothing: each CLI's ``BatchPreprocessing`` is replaced by a recorder
    that stops the run; both receive ``--n_classes`` (2 by default)."""
    seen = {}

    def recorder(side):
        def make(**kwargs):
            seen[side] = kwargs["n_classes"]
            raise _Stop
        return make

    monkeypatch.setattr(jtrain, "BatchPreprocessing", recorder("jax"))
    monkeypatch.setattr(ttrain, "BatchPreprocessing", recorder("torch"))
    args = ["--dataset_json", str(grades / "ds.json"), "--image_keys", "T2",
            "--label_keys", "grade", "--possible_labels", "a", "b", "c",
            "--config_file", str(grades / "cat.yaml"), "--pad_size",
            *map(str, SHAPE), "--target_spacing", "1", "1", "2",
            "--max_epochs", "1", "--n_folds", "1", "--mixup_alpha", "0.4",
            "--label_smoothing", "0.1", "--dev", "cpu", "--checkpoint_dir",
            str(grades / "ckpt"), *extra]
    with pytest.raises(_Stop):
        cli_main(["classification", "train", *args])
    with pytest.raises(_Stop):
        jtrain.main(args)
    assert seen["torch"] == seen["jax"] == (3 if extra else 2)
