"""
Model export and import: a trained network as one standalone artifact.

Counterpart of ``adell_mri_tpu/train/export.py``. There ``jax.export``
serialises the jitted forward with the parameters baked in, and on a TPU
the artifact carries the Pallas kernels inside it. Here ``torch.export``
traces the forward into an ``ExportedProgram`` whose state holds the
trained weights; ``torch.export.save`` writes it. The hand-written
kernels launch through ``ctypes`` on data pointers, which a trace with
fake tensors cannot follow; without a gradient, as here, the stride-1
conv (K1) and the flash forward go through their registered ops
``torch.ops.adell.conv3d_igemm`` and ``torch.ops.adell.flash_attention_fwd``,
which the graph records by name. Run on the card, the artifact launches
the kernels (and counts the launches) as the live model does; on CPU
tensors the ops run their plain versions. The input shape and type are
fixed, f32, as the JAX exporter fixes them, and a JSON sidecar beside the
artifact records them and the caller's metadata.
"""

import json
import logging
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

# the op registrations the artifact's graph names
from adell_mri_torch.ops.kernels import attention as _attention  # noqa: F401
from adell_mri_torch.ops.kernels import conv as _conv  # noqa: F401

logger = logging.getLogger(__name__)


class _Forward(torch.nn.Module):
    """``forward(x)`` of ``model`` under ``fn(model, x)``: the call the
    artifact records."""

    def __init__(self, model: torch.nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, x):
        return self.fn(self.model, x)


def export_model(
    model: torch.nn.Module,
    input_shape: Sequence[int],
    output_path: str,
    metadata: Optional[Dict] = None,
    forward: Optional[Callable] = None,
) -> str:
    """Traces ``forward(model, x)`` (``model(x)`` by default) for an f32
    input of ``input_shape`` on the model's device, in eval mode and
    without gradients, and writes ``output_path`` (``torch.export.save``)
    and ``{output_path}.json`` (``input_shape``, ``input_dtype`` and
    ``metadata``)."""
    device = next(iter(model.parameters())).device
    x = torch.zeros(tuple(input_shape), dtype=torch.float32, device=device)
    model = model.eval()
    with torch.no_grad():
        program = torch.export.export(
            _Forward(model, forward or (lambda m, t: m(t))), (x,),
            strict=False)
    torch.export.save(program, output_path)
    side = {"input_shape": list(input_shape), "input_dtype": "float32",
            **(metadata or {})}
    with open(output_path + ".json", "w") as f:
        json.dump(side, f, default=str, indent=1)
    logger.info("exported model to %s (%d bytes)", output_path,
                os.path.getsize(output_path))
    return output_path


def adell_ops(program) -> Dict[str, int]:
    """How often each ``adell`` op appears in an exported program's
    graph, by its name (``adell.conv3d_igemm.default``, ...)."""
    counts: Dict[str, int] = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("adell."):
            counts[name] = counts.get(name, 0) + 1
    return counts


def load_exported(path: str) -> Tuple[Callable, Dict]:
    """``(callable, sidecar metadata)``: the artifact's forward, which runs
    the ``adell`` ops (imported with this module), and its JSON
    sidecar."""
    program = torch.export.load(path)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return program.module(), meta
