"""
Torch-native checkpoint directories.

Counterpart of ``adell_mri_tpu/train/checkpoints.py`` (``CheckpointManager``)
with the same run layout and sidecar files: ``{root}/{name}_fold{k}/``
holds ``metadata.json`` (``network_config``, ``transform_arguments``,
``n_classes``, ``net_type``, ``monitor``, ``mode``, ...), ``best.json``
(``{"step", "value"}``) and the weights as one ``model.pt`` state dict.
Training keeps in ``model.pt`` the weights of the best monitored epoch
(the latest, until a monitored value exists), the ones ``best.json``
names, so prediction serves what the JAX package's ``best_step`` would.
``last.pt`` holds the state at the end of the latest epoch (parameters,
batch-norm running statistics, optimizer buffers, step, epoch, the
EMA/SWA shadow, the schedule's position and, with gradient
accumulation, the micro-step and the running mean), from which
``resume`` continues an interrupted run and ``status`` tells a finished
fold. Reading the JAX package's orbax directories needs JAX and is not
done here; a JAX UNet's parameters come in through
``interop/from_flax.py``.

``load_params_into`` (warm starts) and ``freeze_mask_by_regex`` are the
JAX functions of those names on the port's parameters, matched by their
JAX tree paths (``from_flax.flax_path``), so that a regex written for
the JAX CLI picks the same leaves. ``warm_start`` is the CLIs'
``--checkpoint`` on them, and ``subtree_warm_start`` their
``--encoder_checkpoint`` and ``--module_paths``.
"""

import json
import logging
import math
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from adell_mri_torch.interop.from_flax import flax_path

logger = logging.getLogger(__name__)

MODEL_FILE = "model.pt"
LAST_FILE = "last.pt"


class CheckpointManager:
    def __init__(
        self,
        root: str,
        name: str = "model",
        fold: int = 0,
        metadata: Optional[Dict[str, Any]] = None,
        monitor: Optional[str] = None,
        mode: str = "min",
    ):
        self.dir = os.path.abspath(os.path.join(root, f"{name}_fold{fold}"))
        self.monitor = monitor
        self.mode = mode
        if metadata is not None:
            self.save_metadata(metadata)

    def begin_run(self, resume: bool = False):
        """A fresh training run drops the ``best.json`` and ``last.pt`` of
        an earlier run: the old best would win every comparison, and the
        old state would be resumed. A resumed run keeps both."""
        if resume:
            return
        for name in ("best.json", LAST_FILE):
            path = os.path.join(self.dir, name)
            if os.path.exists(path):
                os.remove(path)

    def save_metadata(self, metadata: Dict[str, Any]):
        if self.monitor is not None:
            # predict --fold -1 reads the comparison direction from here
            metadata = {"monitor": self.monitor, "mode": self.mode,
                        **metadata}
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, "metadata.json"), "w") as f:
            json.dump(metadata, f, default=str, indent=1)

    def load_metadata(self) -> Dict[str, Any]:
        path = os.path.join(self.dir, "metadata.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def _atomic_save(obj, path: str):
        tmp = path + ".tmp"
        torch.save(obj, tmp)
        os.replace(tmp, path)

    def save(
        self,
        state_dict: Dict[str, torch.Tensor],
        step: int = 0,
        value: Optional[float] = None,
    ):
        """Writes the weights and, with ``value``, records them as best."""
        os.makedirs(self.dir, exist_ok=True)
        self._atomic_save({k: v.detach().cpu() for k, v in state_dict.items()},
                          os.path.join(self.dir, MODEL_FILE))
        if value is not None:
            with open(os.path.join(self.dir, "best.json"), "w") as f:
                json.dump({"step": step, "value": float(value)}, f)

    def _best_value(self) -> Optional[float]:
        path = os.path.join(self.dir, "best.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            value = float(json.load(f)["value"])
        return None if math.isnan(value) else value

    def save_epoch(
        self,
        step: int,
        state_dict: Dict[str, torch.Tensor],
        metrics: Dict[str, float],
    ):
        """End-of-epoch save through the monitor: the weights are written
        when the monitored metric improves on ``best.json`` (a NaN never
        does), and while no monitored value has been recorded yet."""
        value = metrics.get(self.monitor)
        best = self._best_value()
        if value is None or math.isnan(value):
            if not os.path.exists(os.path.join(self.dir, "best.json")):
                self.save(state_dict, step=step)
            return
        better = (
            best is None
            or (self.mode == "min" and value < best)
            or (self.mode == "max" and value > best)
        )
        if better:
            self.save(state_dict, step=step, value=value)

    def load_state_dict(self) -> Dict[str, torch.Tensor]:
        path = os.path.join(self.dir, MODEL_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no {MODEL_FILE} in {self.dir} (the port reads its own "
                "checkpoints; JAX orbax directories are not read yet)"
            )
        return torch.load(path, map_location="cpu", weights_only=True)

    # -- the last state, for resume ------------------------------------------

    def save_last(self, state, epoch: int):
        """Writes ``state`` (a ``TrainState``) as the end of ``epoch``."""
        def host(tree):
            return None if tree is None else {
                k: v.detach().cpu() for k, v in tree.items()}

        os.makedirs(self.dir, exist_ok=True)
        self._atomic_save({
            "epoch": int(epoch),
            "step": int(state.step),
            "params": host(state.params),
            "ema_params": host(state.ema_params),
            "variables": host(state.variables),
            "optimizer": state.tx.opt.state_dict(),
            "schedule_step": int(state.tx.count),
            "accumulator": (state.tx.accumulator_state()
                            if state.tx.every > 1 else None),
        }, os.path.join(self.dir, LAST_FILE))

    def _load_last(self, mmap: bool = False) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.dir, LAST_FILE)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=mmap)

    def status(self, max_epochs: int) -> str:
        """``"fresh"`` (no last state), ``"finished"`` (its epoch reached
        ``max_epochs``) or ``"resume"``."""
        last = self._load_last(mmap=True)
        if last is None:
            return "fresh"
        return "finished" if last["epoch"] >= max_epochs else "resume"

    def resume(self, state) -> Tuple[Any, int]:
        """Restores the last state into ``state`` in place: parameters,
        running statistics, optimizer buffers, step, schedule position and
        the shadow.
        Returns ``(state, start_epoch)``; a fold with no last state
        returns ``(state, 0)`` unchanged."""
        last = self._load_last()
        if last is None:
            return state, 0
        if last.get("accumulator") is not None:
            state.tx.load_accumulator_state(
                last["accumulator"],
                next(iter(state.params.values())).device)
        with torch.no_grad():
            for k, v in state.params.items():
                v.copy_(last["params"][k])
            if state.ema_params is not None and last["ema_params"]:
                for k, v in state.ema_params.items():
                    v.copy_(last["ema_params"][k])
        state.variables = {k: last["variables"][k].to(v.device)
                           for k, v in state.variables.items()}
        state.tx.opt.load_state_dict(last["optimizer"])
        state.tx.count = int(last["schedule_step"])
        state.step = int(last["step"])
        logger.info("resumed from epoch %d (step %d)", last["epoch"],
                    state.step)
        return state, int(last["epoch"])


def correct_classification_bias(params: Dict[str, torch.Tensor],
                                labels: Sequence,
                                positive=1) -> Optional[str]:
    """Sets the classifier's output bias, in place, to the log-odds of
    ``positive`` among ``labels`` (clipped to [1e-6, 1 - 1e-6]), so that
    the network starts calibrated. The output bias is the last 1-d
    ``bias`` of at most 16 entries in ``params``' order, as the JAX
    package takes it in its tree's order. Returns its name (None when
    there is none)."""
    p = float(np.mean(np.asarray(labels) == positive))
    p = min(max(p, 1e-6), 1 - 1e-6)
    names = [k for k, v in params.items()
             if k.endswith("bias") and v.dim() == 1 and v.shape[0] <= 16]
    if not names:
        logger.warning("no classification bias found; skipping")
        return None
    with torch.no_grad():
        params[names[-1]].fill_(float(np.log(p / (1 - p))))
    logger.info("set %s to log-odds of %.4f", names[-1], p)
    return names[-1]


# the leaves of a port state dict that are buffers, not parameters: the
# batch norms' running statistics and the GP head's random features
_BUFFER_LEAVES = ("mean", "var", "w", "b")


def load_params_into(
    params: Dict[str, torch.Tensor],
    loaded: Dict[str, torch.Tensor],
    exclude_patterns: Sequence[str] = (),
) -> List[str]:
    """Copies, in place, the parameters of the state dict ``loaded`` (a
    port checkpoint's ``model.pt``; its buffers are left out, as the JAX
    function takes the checkpoint's ``params`` alone) into ``params``
    (``named_parameters``), matched by JAX tree path (``flax_path``): a
    loaded parameter whose path matches one of ``exclude_patterns``
    (``re.search``), is not in ``params`` or differs in shape is skipped.
    Returns the skipped paths, in ``loaded``'s order (the counterpart of
    ``load_params_into`` in ``adell_mri_tpu/train/checkpoints.py``)."""
    by_path = {flax_path(k, v): v for k, v in params.items()}
    excl = [re.compile(p) for p in exclude_patterns]
    skipped = []
    with torch.no_grad():
        for name, value in loaded.items():
            if name.rsplit(".", 1)[-1] in _BUFFER_LEAVES:
                continue
            path = flax_path(name, value)
            target = by_path.get(path)
            if (any(e.search(path) for e in excl) or target is None
                    or target.shape != value.shape):
                skipped.append(path)
                continue
            target.copy_(value)
    return skipped


def freeze_mask_by_regex(
    params: Dict[str, torch.Tensor],
    freeze_patterns: Sequence[str] = (),
    not_freeze_patterns: Sequence[str] = (),
) -> Dict[str, bool]:
    """True (trainable) for each parameter unless its JAX tree path
    matches one of ``freeze_patterns`` and none of
    ``not_freeze_patterns`` (``re.search``), as the JAX function marks
    its tree."""
    frz = [re.compile(p) for p in freeze_patterns]
    keep = [re.compile(p) for p in not_freeze_patterns]
    mask = {}
    for name, value in params.items():
        path = flax_path(name, value)
        mask[name] = not (any(p.search(path) for p in frz)
                          and not any(p.search(path) for p in keep))
    return mask


def run_manager(ck_path: str) -> CheckpointManager:
    """The run ``{dir}/{name}_fold0`` (the suffix is optional, as in the
    JAX CLIs)."""
    return CheckpointManager(os.path.dirname(ck_path) or ".",
                             name=os.path.basename(ck_path).replace(
                                 "_fold0", ""), fold=0)


def warm_start(model: torch.nn.Module, ck_path: str,
               exclude: Optional[Sequence[str]] = None):
    """Loads into ``model``'s parameters those of the best weights of the
    run ``ck_path`` that ``load_params_into`` matches, leaving out the JAX
    tree paths ``exclude`` names (``--checkpoint``,
    ``--exclude_from_state_dict``)."""
    src = run_manager(ck_path)
    if not os.path.exists(os.path.join(src.dir, MODEL_FILE)):
        logger.warning("warm start: no %s in %s; skipped", MODEL_FILE,
                       src.dir)
        return
    skipped = load_params_into(dict(model.named_parameters()),
                               src.load_state_dict(), exclude or ())
    logger.info("warm start from %s (%d skipped)", ck_path, len(skipped))


REFERENCE_SUFFIXES = (".pt", ".pth", ".ckpt")


# the encoder's subtree in a source run: a U-Net's, a CatNet's, one level
# down (the self-supervised wrapper's ``backbone.ResNetBackbone_0``), else
# the whole tree
ENCODER_SOURCES = ("encoder_backbone", "ResNetBackbone_0",
                   "*.ResNetBackbone_0", "")


def _subtree(state: Dict[str, torch.Tensor], sources: Sequence[str]
             ) -> Dict[str, torch.Tensor]:
    """The first non-empty subtree of ``state`` under the prefixes
    ``sources``, tried in order: ``*`` stands for any top-level name, and
    ``""`` for the whole tree."""
    heads = sorted({k.split(".")[0] for k in state})
    for source in sources:
        for prefix in ([source.replace("*", h, 1) for h in heads]
                       if "*" in source else [source]):
            prefix = f"{prefix}." if prefix else ""
            sub = {k[len(prefix):]: v for k, v in state.items()
                   if k.startswith(prefix)}
            if sub:
                return sub
    return {}


def subtree_warm_start(model: torch.nn.Module, ck_path: str, target: str,
                       sources: Sequence[str], required: bool = True) -> int:
    """Loads the first subtree of ``sources`` (``_subtree``) in the best
    weights of the run ``ck_path`` into ``model``'s subtree ``target``:
    parameters only, the running statistics staying the new model's, as
    the JAX CLIs load a checkpoint's ``params``. Returns the number of
    leaves loaded. Where ``required`` (``--encoder_checkpoint``), a load
    that matched no leaf raises and a reference torch checkpoint is
    refused (importing one is ROADMAP Queue 1 item 10); else
    (``--module_paths``) both only warn, as the JAX CLI does."""
    if required and ck_path.endswith(REFERENCE_SUFFIXES):
        raise NotImplementedError(
            f"{ck_path}: importing a reference torch checkpoint into "
            f"{target} is not ported yet (ROADMAP Queue 1 item 10); pass a "
            "run directory of the port")
    src = run_manager(ck_path)
    if not os.path.exists(os.path.join(src.dir, MODEL_FILE)):
        logger.warning("warm start of %s: no %s in %s; skipped", target,
                       MODEL_FILE, src.dir)
        return 0
    loaded = {f"{target}.{k}": v for k, v in
              _subtree(src.load_state_dict(), sources).items()}
    skipped = load_params_into(dict(model.named_parameters()), loaded)
    n_params = sum(k.rsplit(".", 1)[-1] not in _BUFFER_LEAVES
                   for k in loaded)
    n_loaded = n_params - len(skipped)
    if n_loaded == 0:
        message = (f"warm start of {target} from {ck_path} matched no "
                   "parameters: wrong structure for this model?")
        if required:
            raise ValueError(message)
        logger.warning(message)
    logger.info("warm start of %s from %s (%d loaded, %d skipped)", target,
                ck_path, n_loaded, len(skipped))
    return n_loaded
