"""
The port's SWIN layers and SWIN-UNet against the JAX package, on the CPU.

``window_partition`` and ``swin_attention_mask`` must equal the JAX ones
exactly. ``SWINTransformerBlock`` (a shifted block with padding, a
shifted block whose window spans one axis, an unshifted block) and
``SWINUNet`` (``tests/test_models_extra.py``'s small configuration) take
parameters drawn from a seeded numpy generator through ``from_flax`` and
the same numpy input on both sides in f32: within 1e-5 (absolute on
probabilities, of the output's scale for a block). The factory reads
``sample_configs/unet-swin.yaml`` into the JAX tree's names and shapes.
The flash-attention head-dim padding on the plain kernels matches
``attention_reference`` and its gradient within 2e-5 and 1e-4 of the
scale. Last, the CLI trains, serves and scores SWIN-UNet on the CPU.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adell_mri_tpu.models.layers.vit as jvit
import adell_mri_tpu.ops.pallas.attention as jattn
import adell_mri_torch.models.layers.vit as tvit
from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.config import parsing as jparsing
from adell_mri_tpu.models.segmentation.unetr import SWINUNet as JaxSWINUNet
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.config import parsing as tparsing
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers.activations import get_activation
from adell_mri_torch.models.segmentation.unetr import SWINUNet
from adell_mri_torch.ops.kernels import attention as tattn
from test_torch_unet import random_flax_params

YAML = Path(__file__).resolve().parents[1] / "sample_configs" / (
    "unet-swin.yaml")


def _numpy(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape,window", [
    ((2, 4, 6, 4, 3), (2, 3, 2)),
    ((1, 8, 8, 2, 5), (4, 8, 2)),
    ((3, 6, 4, 2), (3, 2)),
])
def test_window_partition_matches_jax(shape, window):
    x = _numpy(shape, 0)
    want, jgrid = jvit.window_partition(jnp.asarray(x), window)
    got, grid = tvit.window_partition(torch.from_numpy(x), window)
    assert grid == jgrid
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tvit.window_unpartition(got, grid, window, shape[1:-1])
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jvit.window_unpartition(want, jgrid, window, shape[1:-1])))


@pytest.mark.parametrize("spatial,window,shift", [
    ((8, 8, 8), (4, 4, 4), (2, 2, 2)),
    ((8, 8, 4), (4, 4, 4), (2, 2, 0)),
    ((16, 16, 4), (8, 8, 4), (4, 4, 0)),
    ((6, 9, 4), (3, 3, 2), (1, 1, 1)),
])
def test_swin_attention_mask_matches_jax(spatial, window, shift):
    want = np.asarray(jvit.swin_attention_mask(spatial, window, shift))
    got = tvit.swin_attention_mask(spatial, window, shift)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spatial,shift", [
    ((6, 8, 5), True),   # shifted, padded on the first and last axes
    ((8, 8, 4), True),   # the window spans the last axis: no shift there
    ((8, 6, 4), False),  # unshifted, padded on the middle axis
], ids=["shifted_padded", "span_axis", "unshifted"])
def test_swin_block_matches_jax(spatial, shift):
    x = _numpy((2,) + spatial + (16,), 1)
    jm = jvit.SWINTransformerBlock(window_size=(4, 4, 4), n_heads=4,
                                   shift=shift)
    params = random_flax_params(jm, jnp.asarray(x), seed=2)
    tm = tvit.SWINTransformerBlock(16, (4, 4, 4), 4, shift=shift)
    state = from_flax(params)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
    # the wrap mask is made once per shape and kept
    assert len(tm._bias) == (1 if shift else 0)
    if shift:
        bias = next(iter(tm._bias.values()))
        with torch.no_grad():
            tm(torch.from_numpy(x))
        assert next(iter(tm._bias.values())) is bias


def test_swin_block_dropout_only_in_training():
    x = torch.from_numpy(_numpy((1, 8, 8, 4, 8), 3))
    tm = tvit.SWINTransformerBlock(8, (4, 4, 4), 2, shift=True, dropout=0.5)
    with torch.no_grad():
        a, b, c = tm.eval()(x), tm.eval()(x), tm.train()(x)
    assert torch.equal(a, b) and not torch.equal(a, c)


SMALL = dict(embed_dim=8, depths=(2, 2), n_heads=(2, 4),
             window_size=(2, 2, 2))


@pytest.fixture(scope="module")
def swin_pair():
    x = np.random.default_rng(4).uniform(size=(2, 16, 16, 16, 1)).astype(
        np.float32)
    jm = JaxSWINUNet(**SMALL)
    params = random_flax_params(jm, jnp.asarray(x), seed=5)
    tm = SWINUNet(**SMALL)
    tm.load_state_dict(from_flax(params))
    return jm, params, tm.eval(), x


def test_swinunet_matches_jax(swin_pair):
    jm, params, tm, x = swin_pair
    want, bn = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    assert bn is None
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor)
    assert got.shape == x.shape
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-5


def test_swinunet_module_names_follow_the_jax_tree(swin_pair):
    _, params, tm, _ = swin_pair
    top = set(params)
    assert top == {"SWINTransformerBlockStack_0", "Conv_0", "Conv_1",
                   "dec_0", "dec_1"}
    assert top == {k.split(".")[0] for k in tm.state_dict()}
    stack = params["SWINTransformerBlockStack_0"]
    assert {"Conv_0", "merge0", "stage0_block0", "stage1_block1"} <= set(
        stack)
    assert set(stack["stage0_block1"]) == {
        "LayerNorm_0", "MultiHeadAttention_0", "LayerNorm_1", "Dense_0",
        "Dense_1"}
    # the patchify and merge kernels keep flax's layout; the attention's
    # bare proj is a Dense, not a transposed conv
    state = from_flax(params)
    for name in ("Conv_0", "merge0"):
        key = f"SWINTransformerBlockStack_0.{name}.weight"
        np.testing.assert_array_equal(
            state[key].numpy(), np.asarray(stack[name]["kernel"]))
    key = "SWINTransformerBlockStack_0.stage0_block0.MultiHeadAttention_0"
    np.testing.assert_array_equal(
        state[f"{key}.proj.weight"].numpy(),
        np.asarray(stack["stage0_block0"]["MultiHeadAttention_0"]["proj"][
            "kernel"]).T)


def test_yaml_factory_builds_the_jax_tree():
    """``sample_configs/unet-swin.yaml`` through both factories: the same
    parameter names and shapes (the JAX tree from ``eval_shape`` at
    64x64x32, without a forward)."""
    jcfg, _ = jparsing.parse_config_unet(str(YAML))
    tcfg, _ = tparsing.parse_config_unet(str(YAML))
    jm = jfactories.get_segmentation_network("swin", jcfg["network"])
    tm = tfactories.get_segmentation_network("swin", tcfg["network"])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 32, 1)))["params"]
    state = from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    want = {k: tuple(v.shape) for k, v in state.items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    stack = tm.SWINTransformerBlockStack_0
    assert stack.widths == [32, 64, 128, 256]
    heads = [getattr(stack, f"stage{s}_block0").MultiHeadAttention_0
             for s in range(4)]
    assert [m.n_heads for m in heads] == [8] * 4
    assert [m.head_dim for m in heads] == [4, 8, 16, 32]
    # the yaml's leaky_relu is not passed on by either factory
    assert tm.adn_z0.act is get_activation("swish")


def test_factory_refuses_mismatched_heads():
    cfg = {"embedding_size": [8, 16, 32], "n_heads": [2, 4]}
    for factories in (jfactories, tfactories):
        with pytest.raises(ValueError, match="one entry per stage"):
            factories.get_segmentation_network("swin", cfg)
    tm = tfactories.get_segmentation_network(
        "monai_swin", {"embedding_size": [8, 16, 32]})
    assert isinstance(tm, SWINUNet)
    assert [getattr(tm.SWINTransformerBlockStack_0, f"stage{s}_block0")
            .MultiHeadAttention_0.n_heads for s in range(3)] == [3, 6, 12]
    with pytest.raises(NotImplementedError):
        tfactories.get_segmentation_network(
            "swin", {"skip_conditioning": 1})


@pytest.mark.parametrize("d", [4, 8, 16, 48])
def test_flash_head_dim_padding_matches_reference(d):
    """``flash_attention`` on a head dim the kernels lack: q, k, v padded
    to the next kernel head dim, the unpadded D's scale, the output and
    gradients sliced back (here through the plain kernels) against the
    JAX package's ``attention_reference`` and its VJP."""
    rng = np.random.default_rng(d)
    q, k, v, g = (rng.normal(size=(2, 3, 70, d)).astype(np.float32)
                  for _ in range(4))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want, vjp = jax.vjp(jattn.attention_reference, jq, jk, jv)
    want_grads = vjp(jnp.asarray(g))
    assert tattn.padded_head_dim(d) == (32 if d <= 32 else 64)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tattn.flash_attention(*leaves)
    assert out.shape == q.shape
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(out.detach().numpy() - np.asarray(want)).max() < (
        2e-5 * scale)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for got, w in zip(grads, want_grads):
        assert got.shape == q.shape
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() < 1e-4 * np.abs(w).max()
    with torch.no_grad():
        plain = tattn.flash_attention(*(torch.from_numpy(a)
                                        for a in (q, k, v)))
    assert torch.equal(plain, out.detach())


def test_flash_head_dim_above_the_kernels_takes_the_plain_version():
    assert tattn.padded_head_dim(80) is None
    q = torch.from_numpy(_numpy((1, 2, 40, 80), 6))
    want = tattn.attention_reference(q, q, q)
    assert torch.allclose(tattn.flash_attention(q, q, q), want, atol=1e-5)


# -- the CLI ------------------------------------------------------------------

LPS = np.diag([-1.0, -1.0, 2.0, 1.0])
SWIN_CONFIG = {
    "patch_size": [2, 2, 2], "window_size": [4, 4, 4],
    "embedding_size": [8, 16], "n_heads": 2, "dropout_rate": 0.1,
    "norm_type": "instance", "n_channels": 1, "activation_fn": "leaky_relu",
    "learning_rate": 0.005, "batch_size": 1, "weight_decay": 0.05,
    "loss_fn": {"dice": {"eps": 1.0e-6}, "focal": {"gamma": 0.0}},
}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    import yaml

    root = tmp_path_factory.mktemp("swin_cohort")
    rng = np.random.default_rng(0)
    ds = {}
    for i in range(3):
        img = rng.normal(size=(16, 16, 8)).astype(np.float32)
        mask = np.zeros((16, 16, 8), np.float32)
        mask[4:10, 5:12, 2:6] = 1.0
        paths = {}
        for key, data in (("T2", img), ("mask", mask)):
            paths[key] = str(root / f"case_{i}_{key}.nii.gz")
            tnifti.write_nifti(paths[key], data, LPS)
        ds[f"case_{i}"] = paths
    (root / "ds.json").write_text(json.dumps(ds))
    # YAML proper: PyYAML reads JSON's "1e-06" as a string
    (root / "swin.yaml").write_text(yaml.safe_dump(SWIN_CONFIG))
    return root


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("heads", [
    [], ["--deep_supervision", "--bottleneck_classification"],
], ids=["plain", "heads"])
def test_swin_train_predict_test_on_cpu(cohort, heads, capsys):
    """``segmentation train --segmentation_net_type swin`` on random crops
    smaller than the volume (SWIN-UNet takes any size), then predict and
    test rebuild the model, heads and all, from the checkpoint."""
    ckpt = cohort / f"ckpt_{len(heads)}"
    cli_main([
        "segmentation", "train", "--dataset_json", str(cohort / "ds.json"),
        "--image_keys", "T2", "--mask_keys", "mask", "--config_file",
        str(cohort / "swin.yaml"), "--pad_size", "16", "16", "8",
        "--random_crop_size", "8", "8", "8", "--target_spacing", "1", "1",
        "2", "--batch_size", "2", "--max_epochs", "1", "--n_folds", "1",
        "--augment", "intensity", "noise", "affine", "flip",
        "--segmentation_net_type", "swin", "--dev", "cpu",
        "--checkpoint_dir", str(ckpt), "--metric_path",
        str(ckpt / "metrics.csv"), *heads,
    ])
    fold = ckpt / "segmentation_fold0"
    meta = json.loads((fold / "metadata.json").read_text())
    assert meta["net_type"] == "swin"
    assert meta["transform_arguments"]["crop_size"] == [8, 8, 8]
    assert meta["network_config"]["deep_supervision"] == bool(heads)
    state = torch.load(fold / "model.pt", weights_only=True)
    assert ("ds_out_0.weight" in state) == bool(heads)
    assert ("bottleneck_classifier.weight" in state) == bool(heads)
    assert all(bool(torch.isfinite(v).all()) for v in state.values())
    text = (ckpt / "metrics.csv").read_text()
    assert ("loss_class_loss" in text) == bool(heads)

    out = cohort / f"pred_{len(heads)}"
    cli_main(["segmentation", "predict", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--output_path", str(out), "--dev", "cpu",
              "--sliding_window_size", "8", "8", "8"])
    for i in range(3):
        pred = tnifti.read_nifti(str(out / f"case_{i}_prob.nii.gz")).data
        assert pred.shape == (16, 16, 8)
        assert np.isfinite(pred).all()
        assert pred.min() >= 0.0 and pred.max() <= 1.0
    capsys.readouterr()
    cli_main(["segmentation", "test", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--dev", "cpu", "--metric_path", str(ckpt / "test.csv")])
    result = _last_json(capsys.readouterr().out)
    assert result["n_cases"] == 3
    assert 0.0 <= result["dice"] <= 1.0
