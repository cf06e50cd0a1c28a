"""
The port's prediction entry point and its host-side pieces, on the CPU.

Host transforms, geometry inversion and the NIfTI codec must agree with
the JAX package's own (1e-5 abs on unit-scale data). The CLI runs on a
two-case cohort with ``--dev cpu``, resampled to 24x24x12; its NIfTIs
agree to 1e-5 with what the JAX predict pipeline computes from the same
weights.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from adell_mri_tpu.data import nifti as jnifti
from adell_mri_tpu.entrypoints.segmentation import predict as jpredict
from adell_mri_tpu.inference import SegmentationInference as JaxSegInference
from adell_mri_tpu.models.segmentation.unet import UNet as JaxUNet
from adell_mri_tpu.transforms import host as jhost
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.entrypoints.segmentation import predict as tpredict
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.transforms import host as thost
from test_torch_unet import FLAGSHIP_SMALL, random_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LPS = np.array(
    [[-0.9, 0, 0, 10], [0, -1.1, 0, 20], [0, 0, 1.3, -5], [0, 0, 0, 1]]
)


def _volume(seed, shape=(21, 26, 10)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "spacing,size",
    [(None, None), ((1.0, 1.0, 1.2), None), ((1.0, 1.0, 1.2), (24, 24, 12))],
)
def test_resample_to_spec_matches_jax(tmp_path, spacing, size):
    path = str(tmp_path / "v.nii.gz")
    tnifti.write_nifti(path, _volume(0), LPS)
    timg = tnifti.reorient_to_ras(tnifti.read_nifti(path))
    jimg = jnifti.reorient_to_ras(jnifti.read_nifti(path))
    got = thost.resample_to_spec(timg, spacing, size)
    want = jhost.resample_to_spec(jimg, spacing, size)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    for order in (0, 1):
        np.testing.assert_allclose(
            thost.resample_to_spec(timg, spacing, size, interp_order=order),
            jhost.resample_to_spec(jimg, spacing, size, interp_order=order),
            atol=1e-5,
        )


def test_area_resize_and_crop_pad_match_jax():
    vol = _volume(1)
    np.testing.assert_allclose(
        thost.area_resize(vol, (8, 13, 7)),
        jhost.area_resize(vol, (8, 13, 7)),
        atol=1e-6,
    )
    for target in ((16, 30, 10), (25, 20, 4)):
        np.testing.assert_array_equal(
            thost.center_crop_pad(vol, target),
            jhost.center_crop_pad(vol, target),
        )


@pytest.mark.parametrize("resize", [None, (20, 20, 10)])
def test_invert_geometry_matches_jax(tmp_path, resize):
    path = str(tmp_path / "v.nii.gz")
    tnifti.write_nifti(path, _volume(2), LPS)
    img = jnifti.reorient_to_ras(jnifti.read_nifti(path))
    pred = np.random.default_rng(3).uniform(size=(24, 24, 12))
    pred = pred.astype(np.float32)
    spacing = (1.0, 1.0, 1.2)
    np.testing.assert_allclose(
        tpredict._invert_geometry(pred, img, spacing, resize_size=resize),
        jpredict._invert_geometry(pred, img, spacing, resize_size=resize),
        atol=1e-6,
    )


def test_nifti_round_trip_matches_jax(tmp_path):
    vol = _volume(4)
    a, b = str(tmp_path / "a.nii.gz"), str(tmp_path / "b.nii")
    tnifti.write_nifti(a, vol, LPS)
    jnifti.write_nifti(b, vol, LPS)
    for path in (a, b):
        t, j = tnifti.read_nifti(path), jnifti.read_nifti(path)
        np.testing.assert_array_equal(t.data, j.data)
        np.testing.assert_array_equal(t.affine, j.affine)
        tr, jr = tnifti.reorient_to_ras(t), jnifti.reorient_to_ras(j)
        np.testing.assert_array_equal(tr.data, jr.data)
        np.testing.assert_array_equal(tr.affine, jr.affine)
        np.testing.assert_array_equal(
            tnifti.reorient_from_ras(tr.data, t.affine), t.data
        )


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Two LPS cases and a port checkpoint of a small flagship-configuration
    UNet whose parameters come from the JAX UNet."""
    import jax.numpy as jnp

    root = tmp_path_factory.mktemp("cohort")
    ds = {}
    for i in range(2):
        p = str(root / f"case_{i}.nii.gz")
        tnifti.write_nifti(p, _volume(10 + i, (20 + i, 23, 10)), LPS)
        ds[f"case_{i}"] = {"T2": p}
    ds_path = str(root / "ds.json")
    with open(ds_path, "w") as f:
        json.dump(ds, f)
    t_args = {
        "image_keys": ["T2"],
        "target_spacing": [1.0, 1.0, 1.2],
        "target_size": [24, 24, 12],
    }
    metadata = {
        "network_config": {
            k: list(v) if isinstance(v, tuple) else v
            for k, v in FLAGSHIP_SMALL.items()
            if k != "n_classes"
        },
        "transform_arguments": t_args,
        "n_classes": 2,
        "net_type": "unet",
    }
    jm = JaxUNet(**FLAGSHIP_SMALL)
    params = random_flax_params(jm, jnp.zeros((1, 24, 24, 12, 1)), seed=11)
    CheckpointManager(
        str(root / "torch_ckpt"), name="segmentation", fold=0,
        metadata=metadata,
    ).save(from_flax(params), step=1, value=0.5)
    return dict(root=root, ds=ds, ds_path=ds_path, jax=(jm, params),
                t_args=t_args)


def _jax_prediction(cohort, pid):
    """What the JAX predict entry point computes for one case: its load,
    its SegmentationInference (window 16x16x8, stride 0.5, flip TTA), its
    geometry inversion back to the source voxel layout."""
    import jax.numpy as jnp

    jm, params = cohort["jax"]
    t_args = cohort["t_args"]
    raw = jnifti.read_nifti(cohort["ds"][pid]["T2"])
    img = jnifti.reorient_to_ras(raw)
    vol = jhost.resample_to_spec(
        img, t_args["target_spacing"], t_args["target_size"]
    )
    vol = (vol - vol.min()) / max(vol.max() - vol.min(), 1e-6)

    def fn(p, x, rng=None):
        return jm.apply({"params": p}, x)[0].astype(jnp.float32)

    prob = JaxSegInference(
        fn, [params], sliding_window_size=(16, 16, 8), stride=0.5, flip=True
    )(jnp.asarray(vol[..., None].astype(np.float32)))
    inv = jpredict._invert_geometry(
        np.asarray(prob)[..., 0], img, t_args["target_spacing"]
    )
    return jnifti.reorient_from_ras(inv, raw.affine)


CLI_FLAGS = ["--sliding_window_size", "16", "16", "8", "--flip_tta"]


def test_predict_cli_cpu_matches_jax(cohort):
    root, ds_path = cohort["root"], cohort["ds_path"]
    out = str(root / "out_torch")
    cmd = [
        sys.executable, "-m", "adell_mri_torch", "segmentation", "predict",
        "--dataset_json", ds_path, "--checkpoint_dir",
        str(root / "torch_ckpt"), "--output_path", out, "--dev", "cpu",
        "--fold", "-1", *CLI_FLAGS,
    ]
    run = subprocess.run(
        cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert run.returncode == 0, run.stderr[-3000:]
    for i in range(2):
        path = os.path.join(out, f"case_{i}_prob.nii.gz")
        got = tnifti.read_nifti(path)
        src = tnifti.read_nifti(cohort["ds"][f"case_{i}"]["T2"])
        assert got.data.shape == src.data.shape  # source voxel layout
        np.testing.assert_allclose(got.affine, src.affine, atol=1e-6)
        want = _jax_prediction(cohort, f"case_{i}")
        assert np.isfinite(got.data).all()
        assert np.abs(got.data - want).max() < 1e-5


UNETR_CONFIG = {
    "patch_size": [8, 8, 4], "embedding_size": 32, "number_of_blocks": 4,
    "n_heads": 4, "feature_size": 4, "dropout_rate": 0.1, "n_channels": 1,
}


def test_predict_cli_unetr_matches_jax(cohort):
    """A UNETR checkpoint (``net_type`` in its metadata) is rebuilt for
    the checkpoint's target size and serves the whole volume as one
    window; 1e-4 against the JAX UNETR on the same weights (the
    tolerance of the model's own parity test: a transformer's f32 sums in
    two frameworks)."""
    import jax.numpy as jnp

    from adell_mri_tpu.config.factories import get_segmentation_network

    root, t_args = cohort["root"], cohort["t_args"]
    jm = get_segmentation_network("unetr", UNETR_CONFIG, n_classes=2)
    params = random_flax_params(jm, jnp.zeros((1, 24, 24, 12, 1)), seed=12)
    CheckpointManager(
        str(root / "unetr_ckpt"), name="segmentation", fold=0,
        metadata={"network_config": UNETR_CONFIG, "n_classes": 2,
                  "transform_arguments": t_args, "net_type": "unetr"},
    ).save(from_flax(params), step=1, value=0.5)
    out = str(root / "out_unetr")
    # the flag's default names another net type: the metadata decides
    tpredict.main([
        "--dataset_json", cohort["ds_path"], "--checkpoint_dir",
        str(root / "unetr_ckpt"), "--output_path", out, "--dev", "cpu",
        "--prediction_ids", "case_0",
    ])
    raw = jnifti.read_nifti(cohort["ds"]["case_0"]["T2"])
    img = jnifti.reorient_to_ras(raw)
    vol = jhost.resample_to_spec(
        img, t_args["target_spacing"], t_args["target_size"]
    )
    vol = (vol - vol.min()) / max(vol.max() - vol.min(), 1e-6)
    prob = jm.apply(
        {"params": params}, jnp.asarray(vol[None, ..., None], jnp.float32)
    )[0]
    want = jnifti.reorient_from_ras(
        jpredict._invert_geometry(
            np.asarray(prob)[0, ..., 0], img, t_args["target_spacing"]
        ),
        raw.affine,
    )
    got = tnifti.read_nifti(os.path.join(out, "case_0_prob.nii.gz")).data
    assert got.shape == raw.data.shape
    assert np.abs(got - want).max() < 1e-4


def test_predict_cli_binary_mask(cohort):
    root, ds_path = cohort["root"], cohort["ds_path"]
    out = str(root / "out_mask")
    tpredict.main([
        "--dataset_json", ds_path, "--checkpoint_dir",
        str(root / "torch_ckpt"), "--output_path", out, "--dev", "cpu",
        "--prediction_type", "mask", "--threshold", "0.5",
        "--keep_largest_connected_component", "--prediction_ids", "case_1",
        "--precision", "bf16",
    ])
    assert sorted(os.listdir(out)) == ["case_1_prob.nii.gz"]
    mask = tnifti.read_nifti(os.path.join(out, "case_1_prob.nii.gz")).data
    assert mask.dtype == np.uint8 and set(np.unique(mask)) <= {0, 1}


def test_predict_cuda_without_gpu_raises(cohort, monkeypatch):
    root, ds_path = cohort["root"], cohort["ds_path"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--dev cpu"):
        tpredict.main([
            "--dataset_json", ds_path, "--checkpoint_dir",
            str(root / "torch_ckpt"), "--output_path", str(root / "o"),
        ])


@pytest.mark.parametrize(
    "flags", [["--checkpoint_name", "conditioned"],
              ["--checkpoint_name", "flat"]]
)
def test_predict_unported_flags_raise(cohort, flags):
    """What predict still refuses: a conditioned checkpoint (skip keys)
    and a 2D one (every flag of predict is ported)."""
    root, ds_path = cohort["root"], cohort["ds_path"]
    src = CheckpointManager(str(root / "torch_ckpt"), name="segmentation")
    meta = src.load_metadata()
    CheckpointManager(str(root / "torch_ckpt"), name="conditioned",
                      metadata={**meta, "transform_arguments": {
                          **meta["transform_arguments"],
                          "skip_keys": ["T2"]}})
    CheckpointManager(str(root / "torch_ckpt"), name="flat", metadata={
        **meta, "network_config": {**meta["network_config"],
                                   "spatial_dimensions": 2}})
    with pytest.raises(NotImplementedError):
        tpredict.main([
            "--dataset_json", ds_path, "--checkpoint_dir",
            str(root / "torch_ckpt"), "--dev", "cpu",
            "--output_path", str(root / "unported"), *flags,
        ])
