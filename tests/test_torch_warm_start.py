"""
Warm starts, freezing, gradient accumulation and resizing, the port's
against the JAX package's, on the CPU.

``load_params_into``: a 3-class CatNet whose last hidden layer is
narrower loaded into a 2-class GP CatNet, with an exclusion regex: the
resulting parameters equal JAX's bit for bit (copies), the skipped JAX
paths are the same, the running statistics and the random features stay
the target's. ``freeze_mask_by_regex``: leaf for leaf equal to JAX's mask
on the same JAX paths. The port's ``Optimizer`` with
``accumulate_gradients`` and ``freeze_wrap`` against optax's
``MultiSteps`` over ``multi_transform(set_to_zero)`` on the same gradients
(six micro-steps: three updates at k=2; a frozen run at k=1): every
parameter after every call within 1e-5 of its scale, the frozen ones
bit-equal to their start, the schedule advanced once an update.
``ClassificationTransforms`` with ``resize_size`` (and a mask, cropped
around) loads what the JAX one loads (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.train import checkpoints as jck
from adell_mri_tpu.train import optim as joptim
from adell_mri_tpu.train.schedules import (
    cosine_annealing_with_warmup as jschedule,
)
from adell_mri_tpu.transforms import (
    ClassificationTransforms as JaxTransforms,
)
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.interop.from_flax import flax_path, from_flax
from adell_mri_torch.train import checkpoints as tck
from adell_mri_torch.train import optim as toptim
from adell_mri_torch.train.schedules import (
    cosine_annealing_with_warmup as tschedule,
)
from adell_mri_torch.transforms.pipeline import ClassificationTransforms
from test_torch_classification import SHAPE, TINY
from test_torch_gp import GP_TINY, gp_in_features, jax_gp_features
from test_torch_unet import random_flax_params

SOURCE = {**TINY, "classification_structure": [32, 32, 16]}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _port_params(tree):
    """``from_flax`` of a GP CatNet's parameter-shaped tree (gradients,
    updates), without the random features."""
    state = from_flax(tree, gp_features=(np.zeros(1), np.zeros(1)))
    return {k: v for k, v in state.items() if k not in ("gp.w", "gp.b")}


@pytest.fixture(scope="module")
def nets():
    x = jnp.zeros((1,) + SHAPE + (1,))
    target_jm = jfactories.get_classification_network("cat", GP_TINY)
    source_jm = jfactories.get_classification_network("cat", SOURCE,
                                                      n_classes=3)
    target = random_flax_params(target_jm, x, seed=70)
    source = random_flax_params(source_jm, x, seed=71)
    source_bs = jax.tree.map(
        lambda a: np.full(a.shape, 0.5, np.float32),
        source_jm.init(jax.random.PRNGKey(0), x)["batch_stats"])
    tm = tfactories.get_classification_network("cat", GP_TINY)
    tm.load_state_dict({
        **tm.state_dict(),
        **from_flax(target, gp_features=jax_gp_features(
            gp_in_features(target)))})
    return dict(target=target, source=source, source_bs=source_bs, tm=tm)


@pytest.mark.parametrize("exclude", [(), ("ActDropNorm_1",),
                                     ("ResNetBackbone_0/Conv_0", "bias$")])
def test_load_params_into_matches_jax(nets, exclude):
    want, want_skipped = jck.load_params_into(nets["target"], nets["source"],
                                              exclude_patterns=exclude)
    tm = tfactories.get_classification_network("cat", GP_TINY)
    tm.load_state_dict(nets["tm"].state_dict())
    buffers = {k: v.clone() for k, v in tm.named_buffers()}
    loaded = from_flax(nets["source"], nets["source_bs"])
    skipped = tck.load_params_into(dict(tm.named_parameters()), loaded,
                                   exclude)
    assert sorted(skipped) == sorted(want_skipped)
    assert "Dense_3/kernel" in skipped and "Dense_2/kernel" in skipped
    state = tm.state_dict()
    for k, v in from_flax(want, gp_features=(buffers["gp.w"],
                                             buffers["gp.b"])).items():
        assert torch.equal(state[k], v), k
    for k, v in buffers.items():
        assert torch.equal(state[k], v), k


@pytest.mark.parametrize("freeze, keep", [
    (["ResNetBackbone_0"], []), (["ResNetBackbone_0"], ["GlobalBatchNorm"]),
    (["kernel$", "gp"], ["Dense_0"]), ([], ["Dense"])])
def test_freeze_mask_matches_jax(nets, freeze, keep):
    want = _flat(jck.freeze_mask_by_regex(nets["target"], freeze, keep))
    got = tck.freeze_mask_by_regex(dict(nets["tm"].named_parameters()),
                                   freeze, keep)
    assert {flax_path(k, p): got[k]
            for k, p in nets["tm"].named_parameters()} == want


@pytest.mark.parametrize("name, every, frozen", [
    ("adamw", 2, False), ("adamw", 1, True), ("sgd", 2, True),
    ("adam", 2, True)])
def test_optimizer_trajectory_matches_optax(nets, name, every, frozen):
    """Six calls of the same gradients (clipping at global norm 1, weight
    decay 0.01, a warmed-up cosine schedule)."""
    params = jax.tree.map(jnp.asarray, nets["target"])
    freeze, keep = ["ResNetBackbone_0"], ["GlobalBatchNorm"]
    kwargs = dict(weight_decay=0.01, clip_norm=1.0)
    tx = joptim.get_optimizer(name, learning_rate=jschedule(
        0.05, t_max=4, n_warmup_steps=1), params=params, **kwargs)
    if frozen:
        tx = joptim.freeze_wrap(tx, jck.freeze_mask_by_regex(
            params, freeze, keep))
    tx = joptim.accumulate_gradients(tx, every)
    opt_state = tx.init(params)
    tparams = {k: v.clone().requires_grad_(True)
               for k, v in _port_params(nets["target"]).items()}
    opt = toptim.get_optimizer(name, learning_rate=tschedule(
        0.05, t_max=4, n_warmup_steps=1), params=tparams, **kwargs)
    if frozen:
        opt = toptim.freeze_wrap(opt, tck.freeze_mask_by_regex(
            tparams, freeze, keep))
    opt = toptim.accumulate_gradients(opt, every)
    start = {k: v.detach().clone() for k, v in tparams.items()}
    rng = np.random.default_rng(72)
    for call in range(6):
        grads = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.1,
            nets["target"])
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.step(_port_params(grads), tparams)
        assert opt.count == (call + 1) // every
        for k, v in _port_params(params).items():
            got = tparams[k].detach()
            if frozen and k in opt.frozen:
                assert torch.equal(got, start[k]), k
                continue
            scale = max(float(v.abs().max()), 1e-3)
            assert float((got - v).abs().max()) <= 1e-5 * scale, (call, k)
    if frozen:
        assert opt.frozen and not any(
            "GlobalBatchNorm" in k for k in opt.frozen)
        assert all(k.startswith("ResNetBackbone_0.") for k in opt.frozen)
        assert not any(p in opt.opt.state for k, p in tparams.items()
                       if k in opt.frozen)


@pytest.mark.parametrize("cropping", [False, True])
def test_resize_transforms_match_jax(tmp_path, cropping):
    """``resize_size`` scales after the spacing (area; the mask nearest)
    and before the crop or pad to ``target_size``: the port's load equals
    the JAX one's (f32, 1e-6)."""
    rng = np.random.default_rng(73)
    lps = np.diag([-1.0, -1.0, 2.0, 1.0])
    img = rng.normal(size=(20, 18, 10)).astype(np.float32)
    mask = np.zeros((20, 18, 10), np.float32)
    mask[4:15, 5:12, 2:7] = 1.0
    tnifti.write_nifti(str(tmp_path / "img.nii.gz"), img, lps)
    tnifti.write_nifti(str(tmp_path / "mask.nii.gz"), mask, lps)
    entry = {"T2": str(tmp_path / "img.nii.gz"),
             "mask": str(tmp_path / "mask.nii.gz"), "label": 1}
    kwargs = dict(image_keys=["T2"], label_key="label",
                  target_spacing=[1.0, 1.0, 2.0], target_size=[16, 12, 8],
                  resize_size=[14, 13, 6])
    if cropping:
        kwargs.update(mask_key="mask", image_crop_from_mask=True)
    want = JaxTransforms(**kwargs).load_fn()(dict(entry))
    got = ClassificationTransforms(**kwargs).load_fn()(dict(entry))
    assert got["image"].shape == (16, 12, 8, 1)
    np.testing.assert_allclose(got["image"], want["image"], atol=1e-6,
                               rtol=0)
    assert got["label"] == want["label"]
