"""
``classification model_to_export`` (and ``model_to_torchscript``) and
``train/export.py`` against the JAX package's exporter, on the CPU.

A JAX checkpoint of seeded random weights and running statistics and a
port checkpoint of the same weights (``from_flax``), for a batch-norm
CatNet (two stages, batch ensembles of 2) and a one-block ViT classifier
at 2048 tokens (64x64x32 in 4x4x4 patches, and the class token), which
takes the flash forward. Both CLIs export (CatNet at B=4: at B=2 its
1-d head batch norms, normalising two samples, amplify f32 rounding
beyond 1e-5; the ViT at B=2): the sidecars agree, the
port's graph records ``adell.conv3d_igemm`` (CatNet's K1 convs) or
``adell.flash_attention_fwd`` (the ViT's one attention), and the port's
artifact gives the JAX artifact's output and the live port model's
within 1e-5 of their scale (f32). The JAX exporter applies the
parameters alone, so its CatNet's batch norms normalise by the exported
batch, not by the running statistics: the port's artifact does the same
(``batch_statistics_mode``), which this test pins against the served
forward. The JAX exporter fails without ``--batch_size`` (its input shape
starts with None); the port refuses too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.__main__ import main as jax_main
from adell_mri_tpu.config.factories import (
    get_classification_network as jget_network,
)
from adell_mri_tpu.train.checkpoints import CheckpointManager as JaxCkpt
from adell_mri_tpu.train.export import load_exported as jload_exported
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.config.factories import (
    get_classification_network as tget_network,
)
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers.adn import batch_statistics_mode
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.export import adell_ops, load_exported
from test_torch_classification import _close

NETS = {
    "cat": ({"resnet_structure": [[8, 16, 3, 1], [16, 32, 3, 1]],
             "maxpool_structure": [[2, 2, 2], [2, 2, 1]],
             "batch_ensemble": 2, "res_type": "resnet"}, (16, 16, 8),
            {"adell.conv3d_igemm.default": 5}, 4),
    "vit": ({"patch_size": [4, 4, 4], "embedding_size": 32, "n_heads": 2,
             "number_of_blocks": 1}, (64, 64, 32),
            {"adell.flash_attention_fwd.default": 1}, 2),
}


def _draw(tree, rng, stats=False):
    def one(s):
        if stats:
            return jnp.asarray(rng.uniform(0.5, 1.5, s.shape).astype(
                np.float32))
        scale = 0.3 if len(s.shape) == 1 else 1.0 / np.sqrt(
            np.prod(s.shape[:-1]))
        return jnp.asarray((rng.normal(size=s.shape) * scale).astype(
            np.float32))

    return jax.tree.map(one, tree)


@pytest.fixture(scope="module", params=sorted(NETS))
def checkpoints(request, tmp_path_factory):
    """The JAX and the port checkpoint of one network's seeded weights."""
    net = request.param
    cfg, size, _, _ = NETS[net]
    root = tmp_path_factory.mktemp(f"export_{net}")
    meta = {"network_config": cfg, "n_classes": 2, "net_type": net,
            "transform_arguments": {"image_keys": ["T2"],
                                    "target_size": list(size),
                                    "target_spacing": [1.0, 1.0, 2.0]}}
    jm = jget_network(net, cfg, n_classes=2)
    x0 = jnp.zeros((1,) + size + (1,), jnp.float32)
    shapes = jax.eval_shape(lambda v: jm.init(jax.random.PRNGKey(0), v), x0)
    rng = np.random.default_rng(0)
    params = _draw(shapes["params"], rng)
    stats = _draw(shapes.get("batch_stats", {}), rng, stats=True)
    jck = JaxCkpt(str(root / "jax"), name="classification", fold=0,
                  metadata=meta)
    jck.save(0, {"params": params, "variables": {"batch_stats": stats}})
    jck.wait()
    CheckpointManager(str(root / "port"), name="classification", fold=0,
                      metadata=meta).save(from_flax(params, stats))
    return net, root


@pytest.mark.parametrize("mode", ["model_to_export", "model_to_torchscript"])
def test_classification_export(checkpoints, mode, tmp_path):
    net, root = checkpoints
    cfg, size, ops, b = NETS[net]
    jpath, tpath = tmp_path / "jax.bin", tmp_path / "port.pt2"
    jax_main(["classification", mode, "--checkpoint_dir", str(root / "jax"),
              "--output_path", str(jpath), "--batch_size", str(b)])
    cli_main(["classification", mode, "--checkpoint_dir",
              str(root / "port"), "--output_path", str(tpath),
              "--batch_size", str(b), "--dev", "cpu"])
    jfn, jmeta = jload_exported(str(jpath))
    tfn, tmeta = load_exported(str(tpath))
    assert tmeta == jmeta and tmeta["input_shape"] == [b, *size, 1]
    assert adell_ops(torch.export.load(str(tpath))) == ops
    x = np.random.default_rng(1).normal(size=(b, *size, 1)).astype(
        np.float32)
    want = np.asarray(jfn(x))
    got = tfn(torch.from_numpy(x))
    model = tget_network(net, cfg, n_classes=2, image_size=size)
    model.load_state_dict(CheckpointManager(
        str(root / "port"), name="classification", fold=0).load_state_dict())
    with torch.no_grad(), batch_statistics_mode(model.eval()):
        live = model(torch.from_numpy(x))
    _close(got, want, 1e-5)
    _close(got, live, 1e-5)
    if net == "cat":
        # the served forward normalises by the running statistics
        with torch.no_grad():
            served = model(torch.from_numpy(x))
        assert float((served - got).abs().max()) > 1e-3


def test_classification_export_needs_a_batch_size(checkpoints, tmp_path):
    _, root = checkpoints
    with pytest.raises(TypeError):
        jax_main(["classification", "model_to_export", "--checkpoint_dir",
                  str(root / "jax"), "--output_path",
                  str(tmp_path / "jax.bin")])
    with pytest.raises(TypeError, match="--batch_size"):
        cli_main(["classification", "model_to_export", "--checkpoint_dir",
                  str(root / "port"), "--output_path",
                  str(tmp_path / "port.pt2"), "--dev", "cpu"])
