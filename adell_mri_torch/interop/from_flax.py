"""
Moves a JAX UNet's (with a ResNet encoder too), UNETR's, SWINUNet's,
CatNet's, VGG's and OrdNet's (2D or 3D), ConvNeXt's,
UNetEncoderClassifier's, ViTClassifier's, FactorizedViTClassifier's,
HybridClassifier's, NonContrastiveWrapper's, IJEPA's, DINO's, IBOT's,
ViTMaskedAutoEncoder's,
MultipleInstanceClassifier's, TransformableTransformer's,
DeconfoundedNet's, SegCatNet's, ResNet's (and ProjectionHead's) or
SliceLinearEmbedding's parameters (and their ``batch_stats``) into the
port.

The port's module names keep the JAX tree paths (the U-Net's ``enc_{i}``,
``enc_ds_{i}``, ``link_{i}``, ``up_{i}``, ``dec_{i}``, ``Conv_0/Conv_1``;
UNETR's ``LinearEmbedding_0``, ``TransformerBlockStack_0/block_{i}``,
``proj_{i}_{u}``, ``bn_proj``, ``dec_{i}/ConvTranspose_0``; SWIN-UNet's
``SWINTransformerBlockStack_0/{Conv_0,merge{s},stage{s}_block{b}}``; the
heads ``bottleneck_classifier``, ``ds_conv_{i}``, ``ds_out_{i}``;
CatNet's ``ResNetBackbone_0/{Conv_0,Conv_1,ResidualBlock_{i}
(ResNeXtBlock_{i}, ConvNeXtBlock_{i}),BatchEnsembleConv_{s}}``,
``Dense_{i}`` and every ``ActDropNorm_{i}/GlobalBatchNorm_0``; VGG's
``VGGConvolution_{i}/{Conv_0,Conv_1}`` and ``MLP_0/Dense_{i}``;
ConvNeXt's ``backbone/{stem_conv,stem_norm,down_norm_{s},down_conv_{s},
stage{s}_block{b}}``, ``head_norm`` and ``head``; HybridClassifier's
``convolutional_module`` (the headless network) and ``Dense_0/1``;
OrdNet's ``ResNetBackbone_0``, ``Dense_0``, the bias-free ``Dense_1``,
``threshold_bias`` and ``threshold_bias_scale``; UNetEncoderClassifier's
``unet`` (the encoder alone: ``enc_{i}``, ``enc_ds_{i}``) and ``MLP_0``;
the ViT classifiers' ``ViT_0/{LinearEmbedding_0,TransformerBlockStack_0}``
or ``FactorizedViT_0/{LinearEmbedding_0,within_slice,between_slice,
slice_class_token}``, ``SeqPool_0`` and ``MLP_0``;
NonContrastiveWrapper's ``backbone`` (CatNet with ``feature_extraction``),
``proj_{i}``, ``proj_norm`` and ``pred_{i}``; IJEPA's ``embed``,
``ctx_mask_token``, ``context_encoder``, ``ctx2pred``, ``predictor``,
``pred_out`` and ``target_encoder``; DINO's and IBOT's ``embed``,
``encoder`` and ``head/{Dense_{i},prototypes}`` and IBOT's
``mask_token``; ViTMaskedAutoEncoder's ``patch_embed``, ``encoder``,
``enc2dec``, ``mask_token``, ``decoder`` and ``reconstruct``; CatNet's
Gaussian-process head
``gp/beta``; GenericEnsemble's and AveragingEnsemble's
``networks_{i}`` and the fusion head's ``Dense_{i}``; the U-Net's ResNet
encoder ``encoder_backbone`` (a ``ResNetBackbone``'s tree); the MIL
models' slice encoder ``module/VGG_0``, ``MILAttention_0/{V,U,w}``,
``TransformerBlockStack_0``, ``SeqPool_0`` and ``Dense_{i}``;
DeconfoundedNet's ``backbone`` (a CatNet with ``feature_extraction``),
``conf_proj``, ``cls_proj``, ``classifier``, ``cat_conf_{i}`` and
``cont_conf``; ResNet's ``ResNetBackbone_0``, ``ProjectionHead_{i}/
{Dense_{j},ActDropNorm_{j}}`` and ``LayerNorm_0``; SegCatNet's ``unet``,
``final_layer_classifier`` (a ResNet), ``bottleneck_classifier`` (a
ProjectionHead) and the bias-free ``final_layer_linear``,
``bottleneck_linear`` and ``weighted_average``; SliceLinearEmbedding's
``embed``, ``pos_embedding`` and ``class_token``), so
each flax leaf ``a/b/kernel`` becomes the port
key ``a.b.weight``, ``a/b/bias`` becomes ``a.b.bias``, a LayerNorm's or a
batch norm's ``a/b/scale`` becomes ``a.b.weight``, and the token
parameters (``pos_embedding``, ``class_token``, ``registers``,
``ctx_mask_token``, ``slice_class_token``, ``mask_token``), the DINO
head's ``prototypes`` ([bottleneck, out_dim], as the JAX head multiplies
by them), OrdNet's thresholds and a
batch
ensemble's ``r`` and ``s`` keep their names; the ``batch_stats``
collection's ``a/b/mean`` and ``a/b/var`` become the batch norms'
buffers ``a.b.mean`` and ``a.b.var``. Only the layouts change:

- a 3D conv kernel ``[kd,kh,kw,Cin,Cout]`` stays as it is (the port's
  ``Conv3d`` and its kernel read that layout), the patchify and merge
  convs' too, and so does a 2D one ``[kh,kw,Cin,Cout]``;
- a 1x1 conv kernel ``[1,1,1,Cin,Cout]`` or a Dense kernel ``[Cin,Cout]``
  becomes ``[Cout,Cin]`` (the port's ``Pointwise``);
- a transposed conv kernel (a module named ``up_{i}``, ``proj_{i}_{u}``
  or ``ConvTranspose_{i}``) is spatially FLIPPED, since flax's
  ConvTranspose applies its kernel flipped
  (``adell_mri_tpu/ops/conv.py:conv_transpose_block``), and becomes
  ``[Cin,kd,kh,kw,Cout]``; an attention block's ``proj`` Dense is not one
  of them, nor is a 1x1 kernel (the U-Net's ``upsample`` ``up_{i}``, or a
  stride-1 transposed conv), which the port holds as a ``Pointwise``;
- a depthwise kernel ``[kd,kh,kw,1,C]`` stays as it is (``DwConv``), and
  so does a grouped one ``[kd,kh,kw,Cin/g,Cout]`` (the ResNeXt block's,
  ``Conv3d`` with ``groups``: flax and torch order the groups alike).

A prelu ADN's ``prelu``, GRN's ``gamma`` and LayerScale's
``layer_scale`` keep their names. Instance norm without affine
parameters has no keys on either side.
"""

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


# the modules that are transposed convs, by the name that owns the kernel
_TRANSPOSED = re.compile(r"^(up_\d+|proj_\d+_\d+|ConvTranspose_\d+)$")
# leaves that keep their names: the token parameters, a batch ensemble's,
# a prelu ADN's slope, GRN's gamma, LayerScale's scale, OrdNet's thresholds
_KEPT_NAMES = ("pos_embedding", "class_token", "registers", "r", "s",
               "prelu", "gamma", "layer_scale", "ctx_mask_token",
               "slice_class_token", "threshold_bias", "threshold_bias_scale",
               "mask_token", "prototypes")


def _convert_kernel(path, k: np.ndarray) -> np.ndarray:
    if (len(path) >= 2 and _TRANSPOSED.match(path[-2])
            and not all(s == 1 for s in k.shape[:-2])):
        k = np.flip(k, axis=tuple(range(k.ndim - 2)))
        return np.moveaxis(k, -2, 0)
    if k.ndim == 2:
        return k.T
    if all(s == 1 for s in k.shape[:-2]):
        return k.reshape(k.shape[-2], k.shape[-1]).T
    return k


def from_flax(params: Mapping, batch_stats: Mapping = None,
              gp_features: Optional[Tuple[np.ndarray, np.ndarray]] = None
              ) -> Dict[str, torch.Tensor]:
    """``params``: the flax ``params`` tree (nested dict of arrays);
    ``batch_stats``: the running statistics' collection, when the model
    has batch norms; ``gp_features``: ``(w, b)``, the random Fourier
    features that a JAX ``GaussianProcessLayer`` draws inside its call
    (``normal(PRNGKey(0), (in, n)) / length_scale`` and ``uniform(
    PRNGKey(1), (n,), maxval=2 pi)``), which the port's layer keeps as
    the buffers ``w`` and ``b`` beside its ``beta``; every GP head of the
    tree (a ``gp/beta`` kernel) needs them. Returns the port's
    ``state_dict`` (float32 CPU tensors)."""
    state = {}
    for path, leaf in _flatten(batch_stats or {}):
        if path[-1] not in ("mean", "var"):
            raise KeyError(f"no port counterpart for {'/'.join(path)}")
        state[".".join(path)] = torch.from_numpy(
            np.array(leaf, dtype=np.float32, order="C"))
    for path, leaf in _flatten(params):
        name = path[-1]
        if name == "kernel":
            arr, key = _convert_kernel(path, leaf), "weight"
        elif name == "bias":
            arr, key = leaf, "bias"
        elif name == "scale":
            arr, key = leaf, "weight"
        elif name in _KEPT_NAMES:
            arr, key = leaf, name
        else:
            raise KeyError(f"no port counterpart for {'/'.join(path)}")
        state[".".join(path[:-1] + (key,))] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C")  # owned copy
        )
        if path[-3:-1] == ("gp", "beta"):
            if gp_features is None:
                raise ValueError(
                    f"{'/'.join(path)}: a Gaussian-process head needs its "
                    "random features (gp_features)")
            for name, arr in zip(("w", "b"), gp_features):
                state[".".join(path[:-2] + (name,))] = torch.from_numpy(
                    np.array(arr, dtype=np.float32, order="C"))
    return state


def flax_path(name: str, tensor: torch.Tensor) -> str:
    """The JAX tree path of the port's parameter ``name`` (``from_flax``
    read backwards): the dots become slashes and a ``weight`` becomes
    ``scale`` where it is 1-d (every norm's, and nothing else's) and
    ``kernel`` otherwise."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "scale" if tensor.dim() == 1 else "kernel"
    return "/".join(parts)
