"""
The port's data selection against the JAX package's, on the CPU.

Filters, fills, ID parsing, subsampling (with its largest-remainder
strata), ``Dataset``, explicit and K-fold splits, the training-split
exclusions and subsampling, the class count, both samplers and the
``.npz`` disk cache, each on a synthetic dataset dictionary with the same
seed on both sides. The pid lists, folds and sampler indices must be
equal, not merely close. Then ``segmentation train --dev cpu`` with all
ten augmentation flags and every data key on a tiny cohort: each fold's
train and validation IDs equal those the JAX CLI writes for the same
arguments, and a second run reads every sample from the disk cache.
"""

import argparse
import json
import logging
import os

import numpy as np
import pytest
import yaml

from adell_mri_tpu.data import dataset as jdataset
from adell_mri_tpu.data import filters as jfilters
from adell_mri_tpu.data import loader as jloader
from adell_mri_tpu.data import samplers as jsamplers
from adell_mri_tpu.entrypoints import cli_utils as jcli
from adell_mri_tpu.entrypoints.segmentation import train as jtrain
from adell_mri_torch.data import dataset as tdataset
from adell_mri_torch.data import filters as tfilters
from adell_mri_torch.data import loader as tloader
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.data import samplers as tsamplers
from adell_mri_torch.entrypoints import cli_utils as tcli
from adell_mri_torch.entrypoints.segmentation import train as ttrain


def _dataset(n=40, seed=0):
    rng = np.random.default_rng(seed)
    d = {}
    for i in range(n):
        e = {"image": f"/nonexistent/img_{i}.nii.gz",
             "grade": int(rng.integers(0, 4)),
             "site": ["a", "b", "c"][i % 3],
             "tags": str(["x", "y"] if i % 4 == 0 else ["z"])}
        if i % 5:
            e["age"] = float(40 + rng.integers(0, 40))
        if i % 7 == 0:
            e["path"] = "[scan]/file"
        d[f"pid_{i:02d}"] = e
    return d


FILTERS = [
    ["grade=2"], ["grade!=2"], ["age>55"], ["age<60"], ["site(in)a,c"],
    ["site(match)b"], ["site(!match)b"], ["tags=x"], ["path=[scan]/file"],
    ["age>50", "site(in)a,b", "grade!=0"],
]


@pytest.mark.parametrize("optional", [False, True])
@pytest.mark.parametrize("filters", FILTERS, ids=lambda f: "&".join(f))
def test_filters_match_jax(filters, optional):
    d = _dataset()
    got = tfilters.filter_dictionary_with_filters(d, filters, optional)
    want = jfilters.filter_dictionary_with_filters(d, filters, optional)
    assert list(got) == list(want)
    pred_t = tfilters.compile_filters(filters, optional)
    pred_j = jfilters.compile_filters(filters, optional)
    assert [pred_t(e) for e in d.values()] == [pred_j(e) for e in d.values()]


def test_filter_grammar_errors_match_jax():
    for mod in (tfilters, jfilters):
        with pytest.raises(NotImplementedError):
            mod.compile_filters(["grade~2"])


def test_filter_dictionary_family_matches_jax(tmp_path):
    d = _dataset()
    real = tmp_path / "img.nii.gz"
    real.write_bytes(b"")
    d["pid_03"]["image"] = str(real)
    for name, args in (
            ("filter_dictionary_with_presence", (["age"],)),
            ("filter_dictionary_with_existence", (["image"],)),
            ("filter_dictionary_with_possible_labels", ([1, "3"], "grade"))):
        assert list(getattr(tfilters, name)(d, *args)) == list(
            getattr(jfilters, name)(d, *args)), name
    kw = dict(filters_presence=["age"], possible_labels=[0, 1, 2],
              label_key="grade", filters=["site!=a"])
    assert list(tfilters.filter_dictionary(d, **kw)) == list(
        jfilters.filter_dictionary(d, **kw))


def test_fills_match_jax():
    for fn, spec in (("fill_missing_with_value", ["age:33", "extra:1"]),
                     ("fill_conditional", ["age:99^site:b",
                                           "flag:yes^grade:3"])):
        got = getattr(tfilters, fn)(_dataset(), spec)
        want = getattr(jfilters, fn)(_dataset(), spec)
        assert got == want, fn


def test_parse_ids_matches_jax(tmp_path):
    (tmp_path / "ids.json").write_text(json.dumps(["a", "b"]))
    (tmp_path / "map.json").write_text(json.dumps({"c": 1, "d": 2}))
    (tmp_path / "ids.yaml").write_text(yaml.safe_dump(["e", "f"]))
    (tmp_path / "ids.csv").write_text("g,h\ni\n")
    specs = [
        [str(tmp_path / "ids.json"), "x,y", str(tmp_path / "ids.csv")],
        [str(tmp_path / "map.json"), str(tmp_path / "ids.yaml"), "z"],
        "p,q,r", None, [["s", "t"], "u"],
    ]
    for spec in specs:
        for fmt in ("list", "nested_list"):
            assert tdataset.parse_ids(spec, fmt) == jdataset.parse_ids(
                spec, fmt), (spec, fmt)


@pytest.mark.parametrize("size", [1, 7, 13, 39])
@pytest.mark.parametrize("strata", [None, "grade", "site"])
def test_subsample_dataset_matches_jax(size, strata):
    d = _dataset()
    got = tdataset.subsample_dataset(d, size, np.random.default_rng(5),
                                     strata)
    want = jdataset.subsample_dataset(d, size, np.random.default_rng(5),
                                      strata)
    assert list(got) == list(want)
    assert len(got) == size


def _write_dataset(tmp_path, d, name="ds.json"):
    path = tmp_path / name
    path.write_text(json.dumps(d))
    return str(path)


def test_dataset_apply_filters_matches_jax(tmp_path):
    d = _dataset()
    half = list(d)[:20]
    paths = [_write_dataset(tmp_path, {k: d[k] for k in half}, "a.json"),
             _write_dataset(tmp_path, {k: d[k] for k in d if k not in half},
                            "b.json")]
    kw = dict(fill_conditional=["age:90^site:c"],
              fill_missing_with_placeholder=["age:45"],
              possible_labels=[0, 1, 3], label_keys="grade",
              presence_keys=["image"], filter_on_keys=["age>44"],
              filter_is_optional=True, excluded_ids=["pid_05,pid_06"],
              subsample_size=9)
    got = tdataset.Dataset(paths, seed=11)
    want = jdataset.Dataset(paths, seed=11)
    got.apply_filters(**kw)
    want.apply_filters(**kw)
    assert list(got.keys()) == list(want.keys()) and len(got) == 9
    assert got.to_datalist() == want.to_datalist()
    pick = list(got.keys())[::2]
    assert got.to_datalist(pick) == want.to_datalist(pick)
    # the seeded generator goes on in step
    got.subsample_dataset(subsample_size=4)
    want.subsample_dataset(subsample_size=4)
    assert list(got.keys()) == list(want.keys())
    got.subsample_dataset(key_list=pick[:2])
    want.subsample_dataset(key_list=pick[:2])
    assert list(got.keys()) == list(want.keys())


def test_dataset_filter_dictionary_and_fills_match_jax(tmp_path):
    path = _write_dataset(tmp_path, _dataset())
    got, want = tdataset.Dataset(path), jdataset.Dataset(path)
    for ds in (got, want):
        ds.fill_missing_with_value(["age:50"])
        ds.fill_conditional(["grade:9^site:a"])
        ds.filter_dictionary(filters=["grade!=9"], filters_presence=["age"])
    assert got.dataset == want.dataset


@pytest.mark.parametrize("n_folds", [1, 3, 5])
def test_folds_match_jax(n_folds):
    pids = list(_dataset(23))
    assert ttrain.get_folds(pids, n_folds, 7) == jtrain.get_folds(
        pids, n_folds, 7)
    explicit = ["pid_01,pid_04", "pid_10,pid_11,pid_99"]
    assert ttrain.get_folds(pids, n_folds, 7, explicit) == jtrain.get_folds(
        pids, n_folds, 7, explicit)


@pytest.mark.parametrize("fraction", [None, 0.5, 0.01, 1.0])
@pytest.mark.parametrize("excluded", [None, ["pid_02", "pid_17"]])
def test_filter_training_pids_matches_jax(fraction, excluded):
    pids = list(_dataset(30))[::-1]
    for fold in range(3):
        got = tcli.filter_training_pids(pids, excluded, fraction, 42, fold)
        want = jcli.filter_training_pids(pids, excluded, fraction, 42, fold)
        assert got == want


@pytest.mark.parametrize("flags", [
    {}, {"n_classes": 4}, {"positive_labels": ["1"]},
    {"possible_labels": ["a", "b", "c"]},
    {"possible_labels": ["a", "b", "c"], "n_classes": 3},
    {"label_groups": ["0,1", "2"]},
])
def test_derive_n_classes_matches_jax(flags):
    args = argparse.Namespace(**{"n_classes": 2, **flags})
    assert tcli.derive_n_classes(args) == jcli.derive_n_classes(args)
    bad = argparse.Namespace(possible_labels=["a", "b", "c"], n_classes=5)
    for mod in (tcli, jcli):
        with pytest.raises(ValueError):
            mod.derive_n_classes(bad)


@pytest.mark.parametrize("ratio", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("n_samples", [None, 17])
def test_partially_random_sampler_matches_jax(ratio, n_samples):
    classes = [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 2, 0]
    got = tsamplers.PartiallyRandomSampler(classes, non_keep_ratio=ratio,
                                           seed=9)
    want = jsamplers.PartiallyRandomSampler(classes, non_keep_ratio=ratio,
                                            seed=9)
    if n_samples:
        got.set_n_samples(n_samples)
        want.set_n_samples(n_samples)
    for _ in range(3):
        assert list(got) == list(want)
    assert len(got) == len(want)


@pytest.mark.parametrize("n_samples", [None, 4, 9, 25])
def test_random_sampler_matches_jax(n_samples):
    got = tsamplers.RandomSampler(9, seed=3, n_samples=n_samples)
    want = jsamplers.RandomSampler(9, seed=3, n_samples=n_samples)
    for _ in range(3):
        assert list(got) == list(want)
    assert len(got) == len(want)


def _load_counting(calls):
    def load(entry):
        calls.append(entry["identifier"])
        i = int(entry["identifier"].split("_")[1])
        return {"image": np.full((2, 3), i, np.float32),
                "n_fg": np.int32(i), "identifier": entry["identifier"]}
    return load


def test_disk_cache_is_read_the_second_time(tmp_path):
    entries = [{"image": f"x{i}", "identifier": f"pid_{i}"}
               for i in range(3)]
    calls = []
    first = tloader.CachedVolumeDataset(entries, _load_counting(calls),
                                        cache_dir=str(tmp_path / "c"),
                                        cache_fingerprint="fp")
    batch1 = tloader.safe_collate([first[i] for i in range(3)])
    assert calls == ["pid_0", "pid_1", "pid_2"]
    assert (first.disk_reads, first.disk_writes) == (0, 3)
    again = tloader.CachedVolumeDataset(entries, _load_counting(calls),
                                        cache_dir=str(tmp_path / "c"),
                                        cache_fingerprint="fp")
    batch2 = tloader.safe_collate([again[i] for i in range(3)])
    assert len(calls) == 3  # not loaded again
    assert (again.disk_reads, again.disk_writes) == (3, 0)
    assert batch2.keys() == batch1.keys()
    np.testing.assert_array_equal(batch2["image"], batch1["image"])
    np.testing.assert_array_equal(batch2["n_fg"], batch1["n_fg"])
    assert batch2["n_fg"].dtype == batch1["n_fg"].dtype
    assert list(batch2["identifier"]) == list(batch1["identifier"])
    # the same file name as the JAX package's cache for the same key
    jds = jloader.CachedVolumeDataset(entries, _load_counting([]),
                                      cache_dir=str(tmp_path / "c"),
                                      cache_fingerprint="fp")
    assert all(again.disk_path(e) == jds._disk_path(e) for e in entries)
    # another fingerprint misses; a truncated file is loaded again
    other = tloader.CachedVolumeDataset(entries, _load_counting(calls),
                                        cache_dir=str(tmp_path / "c"),
                                        cache_fingerprint="fp2")
    other[0]
    assert len(calls) == 4 and other.disk_writes == 1
    with open(again.disk_path(entries[1]), "wb") as f:
        f.write(b"PK\x03")
    fresh = tloader.CachedVolumeDataset(entries, _load_counting(calls),
                                        cache_dir=str(tmp_path / "c"),
                                        cache_fingerprint="fp")
    assert float(fresh[1]["image"][0, 0]) == 1.0
    assert calls[-1] == "pid_1" and fresh.disk_writes == 1


# -- the train CLI -----------------------------------------------------------

CONFIG = {
    "spatial_dimensions": 3, "conv_type": "regular",
    "link_type": "residual", "upscale_type": "transpose",
    "norm_type": "instance", "activation_fn": "swish", "depth": [4, 4, 8],
    "kernel_sizes": [3, 3, 3], "strides": [2, 2, 2], "learning_rate": 0.01,
    "loss_fn": {"dice": {}},
}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """8 cases at 16x16x8, lesion-free every third, ``site`` on all and
    ``age`` on all but one (for the filters)."""
    root = tmp_path_factory.mktemp("data_select_cohort")
    rng = np.random.default_rng(0)
    ds = {}
    for i in range(8):
        img = rng.normal(size=(16, 16, 8)).astype(np.float32)
        mask = np.zeros((16, 16, 8), np.float32)
        if i % 3:
            mask[4:10, 5:12, 2:6] = 1.0
        entry = {}
        for key, data in (("T2", img), ("mask", mask)):
            entry[key] = str(root / f"case_{i}_{key}.nii.gz")
            tnifti.write_nifti(entry[key], data,
                               np.diag([-1.0, -1.0, 2.0, 1.0]))
        entry["site"] = ["a", "b"][i % 2]
        if i != 5:
            entry["age"] = 50 + 3 * i
        ds[f"case_{i}"] = entry
    (root / "ds.json").write_text(json.dumps(ds))
    (root / "unet.json").write_text(json.dumps(CONFIG))
    (root / "folds.txt").write_text("case_3,case_4\n")
    return root


AUGMENT = ["--augment", "intensity", "noise", "rbf", "affine", "shear",
           "flip", "blur", "distort", "lowres", "trivial"]
SELECTIONS = {
    "explicit_folds": [
        "--filter_on_keys", "age>52", "--filter_is_optional",
        "--excluded_ids", "case_7", "--folds", "case_1,case_2",
        "FOLDS_FILE", "--excluded_ids_from_training_data", "case_6",
        "--subsample_training_data", "0.8", "--constant_ratio", "0.5",
        "--validation_samples_per_epoch", "1", "--possible_labels", "0",
        "1"],
    "kfold_subsample": [
        "--filter_on_keys", "site(in)a,b", "--subsample_size", "6",
        "--n_folds", "3", "--excluded_ids_from_training_data", "case_2",
        "--validation_samples_per_epoch", "3", "--possible_labels", "0", "1",
        "2"],
}


def _cli_args(root, ckpt, selection, epochs):
    sel = [str(root / "folds.txt") if a == "FOLDS_FILE" else a
           for a in SELECTIONS[selection]]
    return [
        "--dataset_json", str(root / "ds.json"), "--image_keys", "T2",
        "--mask_keys", "mask", "--config_file", str(root / "unet.json"),
        "--pad_size", "16", "16", "8", "--target_spacing", "1", "1", "2",
        "--batch_size", "1", "--max_epochs", str(epochs),
        "--steps_per_epoch", "1", "--seed", "3", "--dev", "cpu",
        "--checkpoint_dir", str(ckpt), "--metric_path",
        str(ckpt / "metrics.csv"), *AUGMENT, *sel,
    ]


def _folds_written(ckpt):
    out = []
    for name in sorted(os.listdir(ckpt)):
        if name.startswith("segmentation_fold"):
            meta = json.loads((ckpt / name / "metadata.json").read_text())
            out.append((meta["train_pids"], meta["val_pids"],
                        meta["n_classes"]))
    return out


@pytest.mark.parametrize("selection", list(SELECTIONS))
def test_train_cli_data_selection_matches_jax(cohort, caplog, selection):
    """Every fold's IDs and the class count as the JAX CLI writes them;
    the port trains one step a fold with all ten flags on, then a second
    run reads every sample from ``--cache_dir``."""
    jck = cohort / f"jax_{selection}"
    jtrain.main(_cli_args(cohort, jck, selection, 0))
    want = _folds_written(jck)
    tck = cohort / f"torch_{selection}"
    cache = ["--cache_dir", str(cohort / f"cache_{selection}")]
    with caplog.at_level(logging.INFO,
                         logger="adell_mri_torch.entrypoints.segmentation"):
        ttrain.main(_cli_args(cohort, tck, selection, 1) + cache)
        first = [r.getMessage() for r in caplog.records
                 if "disk cache" in r.getMessage()]
        caplog.clear()
        ttrain.main(_cli_args(cohort, cohort / f"torch2_{selection}",
                              selection, 1) + cache)
        second = [r.getMessage() for r in caplog.records
                  if "disk cache" in r.getMessage()]
    got = _folds_written(tck)
    assert got == want and len(got) == (2 if "folds" in selection
                                        else 3)
    assert got == _folds_written(cohort / f"torch2_{selection}")
    assert all(os.path.exists(tck / f"segmentation_fold{i}" / "model.pt")
               for i in range(len(got)))
    # the first run writes each new sample once; the second writes none
    assert first and any(not m.endswith(" 0 written") for m in first)
    assert second and all(m.endswith(" 0 written") for m in second)
    assert not any(" 0 read" in m for m in second)
