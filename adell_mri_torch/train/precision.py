"""
Mixed-precision policy of the train and eval steps.

Counterpart of ``adell_mri_tpu/train/precision.py``: the Lightning
spellings map to a compute dtype (None meaning full f32); ``wrap_apply``
runs a forward on compute-dtype copies of the f32 master parameters and
inputs and returns f32 outputs. The casts are differentiable, so
gradients land on the f32 masters. ``torch.autocast`` is not used: it
does not reach the hand-written conv kernel, which takes x, w and bias in
one dtype.
"""

from typing import Any, Callable, Optional

import torch

_PRECISION_ALIASES = {
    "32": None,
    "32-true": None,
    "f32": None,
    "fp32": None,
    "bf16": torch.bfloat16,
    "bf16-mixed": torch.bfloat16,
    "bf16-true": torch.bfloat16,
    # the JAX package maps the reference's 16-bit spellings to bf16 too
    "16": torch.bfloat16,
    "16-mixed": torch.bfloat16,
    "16-true": torch.bfloat16,
    "f16": torch.bfloat16,
}


def compute_dtype(precision: Optional[str]) -> Optional[torch.dtype]:
    if precision is None:
        return None
    key = str(precision).lower()
    if key not in _PRECISION_ALIASES:
        raise ValueError(
            f"unknown precision {precision!r}; "
            f"one of {sorted(_PRECISION_ALIASES)}"
        )
    return _PRECISION_ALIASES[key]


def cast_floats(tree: Any, dtype) -> Any:
    """Casts the floating tensors of a dict/list/tuple tree to ``dtype``;
    other leaves are returned as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


def wrap_apply(apply_fn: Callable, precision: Optional[str]) -> Callable:
    """``apply_fn(params, *args)`` with params and inputs cast to the
    compute dtype and float outputs cast to f32; ``apply_fn`` itself at
    full f32."""
    dtype = compute_dtype(precision)
    if dtype is None:
        return apply_fn

    def wrapped(params, *args):
        out = apply_fn(cast_floats(params, dtype), *cast_floats(args, dtype))
        return cast_floats(out, torch.float32)

    return wrapped
