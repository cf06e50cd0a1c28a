"""
Test-time augmentation and composed inference.

Counterpart of ``adell_mri_tpu/inference/tta.py``: ``FlippedInference``,
``TensorListReduction`` and ``SegmentationInference``, composing the
sliding window, flip TTA, MC dropout and checkpoint ensembling.
"""

from typing import Callable, List, Optional, Sequence

import torch

from adell_mri_torch.inference.sliding_window import SlidingWindowSegmentation


class FlippedInference:
    """Averages predictions over flips: for each axis subset, flip the
    input, predict, flip back. The unflipped prediction comes first."""

    def __init__(
        self,
        inference_function: Callable,
        flips: Sequence[Sequence[int]] = ((0,), (1,), (2,)),
    ):
        self.fn = inference_function
        self.flips = [()] + [tuple(f) for f in flips if tuple(f) != ()]

    def __call__(self, vol: torch.Tensor) -> torch.Tensor:
        preds = []
        for axes in self.flips:
            x = torch.flip(vol, axes) if axes else vol
            p = self.fn(x)
            preds.append(torch.flip(p, axes) if axes else p)
        return sum(preds) / len(preds)


class TensorListReduction:
    """Mean of a list of prediction tensors."""

    def __call__(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        return sum(tensors) / len(tensors)


class SegmentationInference:
    """Per-checkpoint model -> [MC-dropout repeats] -> [sliding window]
    -> [flip TTA] -> mean.

    Args:
        base_inference_function: ``(params, x, mc=False) -> probs`` on a
            batch of windows or volumes; ``params`` is one entry of
            ``checkpoint_params`` (for the port, a model); ``mc=True``
            asks for a training-mode forward (dropout drawn, batch norms
            on the batch's statistics), as the JAX package applies its
            model with ``train=True`` and a dropout key.
        checkpoint_params: the ensemble's members.
        sliding_window_size: enables windowed inference when set.
        stride, flip: as the CLI exposes them.
        mc_iterations: with a count, each window batch (or volume) is the
            mean of that many ``mc=True`` forwards (MC dropout).
    """

    def __init__(
        self,
        base_inference_function: Callable,
        checkpoint_params: Sequence,
        sliding_window_size: Optional[Sequence[int]] = None,
        stride: float = 0.5,
        flip: bool = False,
        mc_iterations: Optional[int] = None,
        batch_size: int = 4,
    ):
        self.base_fn = base_inference_function
        self.mc_iterations = mc_iterations
        self.checkpoint_params = list(checkpoint_params)
        self.sliding_window_size = sliding_window_size
        self.flip = flip
        self.reduction = TensorListReduction()
        self.sw = None
        if sliding_window_size is not None:
            self.sw = SlidingWindowSegmentation(
                sliding_window_size,
                self._member_fn,
                stride=stride,
                batch_size=batch_size,
                with_params=True,
            )

    def _member_fn(self, params, x):
        """One member's probabilities: the mean of ``mc_iterations``
        training-mode forwards, or one eval forward."""
        if not self.mc_iterations:
            return self.base_fn(params, x)
        preds = [self.base_fn(params, x, mc=True)
                 for _ in range(self.mc_iterations)]
        return sum(preds) / len(preds)

    def __call__(self, vol: torch.Tensor) -> torch.Tensor:
        """vol [*S, C], one case; returns [*S, C_out] in f32."""
        ndim = vol.dim() - 1
        outputs = []
        for params in self.checkpoint_params:
            if self.sw is not None:
                fn = lambda x, _p=params: self.sw(x, _p)  # noqa: E731
            else:
                fn = lambda x, _p=params: self._member_fn(  # noqa: E731
                    _p, x[None]
                )[0]
            if self.flip:
                fn = FlippedInference(fn, flips=[(d,) for d in range(ndim)])
            outputs.append(fn(vol))
        return self.reduction(outputs)
