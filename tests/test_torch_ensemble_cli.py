"""
``classification_ensemble {train,test,predict}``, the port's against the
JAX CLI's, on the CPU.

Two tiny CatNet members with batch ensembles of 2 (the yaml's kind of
member: the JAX CLI trains them, its step hands flax an ``ensemble``
stream) on the 6-case cohort, two epochs at the configs' rate of 0.01,
from the JAX CLI's initial weights moved into the port's ensemble; each
batch-ensemble layer takes member ``i % 2`` for sample ``i`` on both
sides (their random draws differ). Held: ``metadata.json``
(``member_configs``, ``n_members``, the fold), the best epoch, the kept
weights (1e-4 of each leaf's scale; the checkpoint's statistics the
initial (0, 1) on the port's side, as the JAX state carries none),
``test``'s metrics and ``predict``'s probabilities (1e-4).

AdamW's first update moves an element by the rate whatever its
gradient's size once that size is far above ``eps``. Some gradients are
rounding noise in both packages: the conv biases ahead of a training
batch norm, which no output sees, and, at these weights, one element of
the second member's stem conv (its f64 gradient is 6e-8 of its leaf's
largest, JAX's and the port's f32 ones have opposite signs). Under the
default ``eps`` of 1e-8 that element moves by +0.01 on one side and
-0.01 on the other, and the runs part from there. So both CLIs' AdamW
take ``EPS`` = 1e-2 instead: an update of a gradient at rounding level
then stays far below the bound (1e-3 still left an element near ``eps``
1.6e-4 of its leaf's scale apart), while the rate, the schedule and
the moments are held as they are. The leaves left out of the weights'
check are the ones whose gradient in the JAX CLI's first step is at
rounding level (largest element below 1e-5 of the largest of all, the
rule of ``test_torch_ensemble.py``'s step test): at these weights the
29 conv biases ahead of batch norms, of 142 leaves.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from adell_mri_tpu.__main__ import main as jax_main
from adell_mri_tpu.config.factories import (
    get_classification_network as jget_network,
)
from adell_mri_tpu.entrypoints.classification_ensemble import (
    train as jtrain,
)
from adell_mri_tpu.models.classification import GenericEnsemble as JaxGeneric
from adell_mri_tpu.train.checkpoints import CheckpointManager as JaxCkpt
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.entrypoints.classification_ensemble import (
    train as ttrain,
)
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers.batch_ensemble import BatchEnsembleConv
from test_torch_classification_cli import (
    NETWORK,
    SHAPE,
    TOL,
    _last_json,
    cohort,
)

__all__ = ["cohort"]
OTHER = {**NETWORK, "resnet_structure": [[8, 8, 3, 1], [8, 24, 3, 1]]}
LR = 0.01
EPS = 1e-2
# the rule of test_torch_ensemble.py's step test
ROUNDING = 1e-5


def _patch_adamw_eps(monkeypatch):
    """Both CLIs' AdamW with ``eps=EPS``."""
    jget = jtrain.get_optimizer
    monkeypatch.setattr(jtrain, "get_optimizer",
                        lambda *a, **k: jget(*a, eps=EPS, **k))
    tget = ttrain.get_optimizer

    def tget_eps(*a, **k):
        tx = tget(*a, **k)
        for group in tx.opt.param_groups:
            group["eps"] = EPS
        return tx

    monkeypatch.setattr(ttrain, "get_optimizer", tget_eps)


def _first_jax_gradient(monkeypatch):
    """The gradient of the JAX CLI's first step, filled in when it runs."""
    first = {}
    make = jtrain.make_train_step

    def recording(loss_and_metrics, *a, **k):
        step = make(loss_and_metrics, *a, **k)

        def train_step(state, batch, rng):
            if not first:
                first.update(from_flax(jax.grad(
                    lambda p: loss_and_metrics(
                        p, batch, jax.random.fold_in(rng, state.step))[0])(
                    state.params)))
            return step(state, batch, rng)

        return train_step

    monkeypatch.setattr(jtrain, "make_train_step", recording)
    return first


def test_ensemble_clis_match_jax(cohort, capsys, monkeypatch):
    configs = []
    for i, net in enumerate((NETWORK, OTHER)):
        path = cohort / f"member_{i}.yaml"
        path.write_text(yaml.safe_dump({**net, "learning_rate": LR,
                                        "batch_size": 2}))
        configs.append(str(path))
    jm = JaxGeneric(networks=[jget_network("cat", n)
                              for n in (NETWORK, OTHER)])
    init = jm.init({"params": jax.random.PRNGKey(0)},
                   np.zeros((1,) + SHAPE + (1,), np.float32))
    build = ttrain.ensemble_network

    def from_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        model.load_state_dict(from_flax(init["params"],
                                        init["batch_stats"]))
        return model

    monkeypatch.setattr(ttrain, "ensemble_network", from_jax_init)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k:
                        jnp.arange(shape[0]) % hi)
    monkeypatch.setattr(BatchEnsembleConv, "draw_members",
                        lambda self, b, device: torch.arange(
                            b, device=device) % self.n_ensemble)
    _patch_adamw_eps(monkeypatch)
    grads = _first_jax_gradient(monkeypatch)
    common = ["--dataset_json", str(cohort / "ds.json"), "--dev", "cpu"]
    out = {}
    for side, main in (("jax", jax_main), ("torch", cli_main)):
        ck = cohort / f"ensemble_{side}"
        main(["classification_ensemble", "train", *common, "--image_keys",
              "T2", "--config_files", *configs, "--pad_size",
              *map(str, SHAPE), "--target_spacing", "1", "1", "2",
              "--max_epochs", "2", "--seed", "0", "--checkpoint_dir",
              str(ck), "--metric_path", str(ck / "m.csv")])
        capsys.readouterr()
        main(["classification_ensemble", "test", *common,
              "--checkpoint_dir", str(ck), "--metric_path",
              str(ck / "t.csv")])
        test = _last_json(capsys.readouterr().out)
        main(["classification_ensemble", "predict", *common,
              "--checkpoint_dir", str(ck), "--output_path",
              str(ck / "p.json")])
        run = ck / "ensemble_fold0"
        meta = json.loads((run / "metadata.json").read_text())
        best = json.loads((run / "best.json").read_text())["step"]
        out[side] = (meta, best, test,
                     json.loads((ck / "p.json").read_text()))
    (jmeta, jbest, jtest, jpred) = out["jax"]
    (tmeta, tbest, ttest, tpred) = out["torch"]
    assert tbest == jbest
    for key in ("n_members", "n_classes", "net_type", "member_configs",
                "transform_arguments"):
        assert tmeta[key] == jmeta[key], key
    jck = JaxCkpt(str(cohort / "ensemble_jax"), name="ensemble", fold=0)
    want = from_flax(jck.restore(jck.best_step())["params"])
    got = torch.load(cohort / "ensemble_torch" / "ensemble_fold0"
                     / "model.pt", weights_only=True)
    gscale = max(float(g.abs().max()) for g in grads.values())
    held = [k for k, g in grads.items()
            if float(g.abs().max()) >= ROUNDING * gscale]
    assert set(grads) == set(want) and len(held) > len(want) // 2
    for k in held:
        w = want[k]
        scale = max(float(w.abs().max()), 1e-3)
        assert float((got[k] - w).abs().max()) <= TOL * scale, k
    stats = [k for k in got if k.endswith((".mean", ".var"))]
    assert stats and all(torch.equal(got[k], torch.full_like(
        got[k], float(k.endswith(".var")))) for k in stats)
    assert set(ttest) == set(jtest) and ttest["n_cases"] == 6
    for k, v in jtest.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(ttest[k]), k
        else:
            assert abs(ttest[k] - v) <= TOL, (k, ttest[k], v)
    assert set(tpred) == set(jpred)
    for pid, v in jpred.items():
        assert abs(tpred[pid] - v) <= TOL, (pid, tpred[pid], v)
