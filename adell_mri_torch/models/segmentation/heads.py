"""
Bottleneck classification and deep supervision, the two auxiliary heads
that the port's U-Net, UNETR and SWIN-UNet share.

Counterpart of the ends of the ``UNet``, ``UNETR`` and ``SWINUNet``
forwards in ``adell_mri_tpu/models/segmentation/{unet,unetr}.py``: a Dense
``bottleneck_classifier`` on the spatial maximum of the bottleneck
(logits), and per decoder output ``ds_conv_{i}`` (3x3x3, the hand-written
conv kernel on the card), ``ds_adn_{i}`` and the 1x1 ``ds_out_{i}``
(probabilities). The heads are attributes of the model itself, so their
names are the JAX tree's top-level paths. With a head on, a forward
returns ``(pred, bn_out)`` or, with deep supervision, ``(pred, bn_out,
ds)`` as the JAX forward does (``bn_out`` None without bottleneck
classification); with neither, or with ``heads=False``, the prediction
alone and no head runs: inference takes that, as the JAX predict's jit
drops the unused heads.
"""

import torch

from adell_mri_torch.models.layers.blocks import _tuple, apply_adn
from adell_mri_torch.ops.conv import Conv3d, Pointwise


def add_heads(model, adn_fn, out_channels: int, bottleneck_channels: int,
              decoder_channels, bottleneck_classification: bool,
              deep_supervision: bool):
    """Adds the heads that are on to ``model``; ``decoder_channels``: the
    widths of the decoder outputs, deepest first."""
    model.bottleneck_classification = bottleneck_classification
    model.deep_supervision = deep_supervision
    if bottleneck_classification:
        model.bottleneck_classifier = Pointwise(
            bottleneck_channels, out_channels
        )
    if deep_supervision:
        for i, d in enumerate(decoder_channels):
            model.add_module(f"ds_conv_{i}", Conv3d(d, d, _tuple(3, 3)))
            model.add_module(f"ds_adn_{i}", adn_fn(d))
            model.add_module(f"ds_out_{i}", Pointwise(d, out_channels))


def with_heads(model, pred, bottleneck, deep_outputs, heads: bool = True):
    """``pred`` alone, or with the outputs of ``model``'s heads unless
    ``heads`` is False."""
    if not heads or not (model.bottleneck_classification
                         or model.deep_supervision):
        return pred
    bn_out = None
    if model.bottleneck_classification:
        pooled = bottleneck.reshape(
            bottleneck.shape[0], -1, bottleneck.shape[-1]
        ).amax(dim=1)
        bn_out = model.bottleneck_classifier(pooled)
    if not model.deep_supervision:
        return pred, bn_out
    ds = []
    for i, o in enumerate(deep_outputs):
        y = getattr(model, f"ds_conv_{i}")(o)
        y = apply_adn(getattr(model, f"ds_adn_{i}"), y)
        y = getattr(model, f"ds_out_{i}")(y)
        ds.append(torch.softmax(y, -1) if y.shape[-1] > 1
                  else torch.sigmoid(y))
    return pred, bn_out, ds


def prediction_of(out):
    """The prediction of a model's output, with or without its heads."""
    return out[0] if isinstance(out, tuple) else out
