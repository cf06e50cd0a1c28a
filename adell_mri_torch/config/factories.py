"""
Network factory: config dict + net-type string -> the port's module.

Counterpart of ``get_segmentation_network`` in
``adell_mri_tpu/config/factories.py``, for ``net_type`` "unet", "unetr",
"monai_unetr", "swin" and "monai_swin"; the same config keys, fallbacks
and defaults reach the port's ``UNet``, ``UNETR`` and ``SWINUNet``, which
raise for the options they do not serve yet. A flax module learns its
input size at the first call; the port's UNETR needs it when it is built
(``image_size``), and UNETR and SWIN-UNet need ``n_channels`` from the
config.
"""

from typing import Any, Dict, Optional, Sequence

from adell_mri_torch.models.segmentation.unet import UNet
from adell_mri_torch.models.segmentation.unetr import UNETR, SWINUNet


def _unet_kwargs(cfg: Dict[str, Any], n_classes: int) -> Dict[str, Any]:
    return dict(
        spatial_dimensions=cfg.get("spatial_dimensions", 3),
        conv_type=cfg.get("conv_type", "regular"),
        link_type=cfg.get("link_type", "identity"),
        upscale_type=cfg.get("upscale_type", "upsample"),
        interpolation=cfg.get("interpolation", "linear"),
        norm_type=cfg.get("norm_type", "instance"),
        dropout_param=cfg.get("dropout_param", 0.0),
        activation_fn=cfg.get("activation_fn", "swish"),
        in_channels=int(cfg.get("n_channels", 1)),
        n_classes=n_classes,
        depth=tuple(cfg.get("depth", (16, 32, 64))),
        kernel_sizes=tuple(cfg.get("kernel_sizes", (3, 3, 3))),
        strides=tuple(
            tuple(s) if isinstance(s, (list, tuple)) else s
            for s in cfg.get("strides", (2, 2, 2))
        ),
        bottleneck_classification=cfg.get("bottleneck_classification", False),
        skip_conditioning=cfg.get("skip_conditioning"),
        feature_conditioning=cfg.get("feature_conditioning"),
        feature_conditioning_params=cfg.get("feature_conditioning_params"),
        deep_supervision=cfg.get("deep_supervision", False),
        encoder_structure=cfg.get("encoder_structure") or None,
        res_type=cfg.get("res_type", "resnet"),
        dropout_type=cfg.get("dropout_type", "dropout"),
        semi_supervised=cfg.get("semi_supervised", False),
    )


def _unetr_kwargs(cfg: Dict[str, Any], n_classes: int) -> Dict[str, Any]:
    return dict(
        in_channels=int(cfg.get("n_channels", 1)),
        spatial_dimensions=cfg.get("spatial_dimensions", 3),
        n_classes=n_classes,
        patch_size=tuple(cfg.get("patch_size", (8, 8, 8))),
        embed_dim=cfg.get(
            "embed_dim", cfg.get("hidden_dim", cfg.get("embedding_size", 192))
        ),
        n_blocks=cfg.get("n_blocks", cfg.get("number_of_blocks", 8)),
        n_heads=cfg.get("n_heads", cfg.get("number_of_attention_heads", 6)),
        feature_size=cfg.get("feature_size", 16),
        norm_type=cfg.get("norm_type", "instance"),
        dropout_param=cfg.get("dropout_param", cfg.get("dropout_rate", 0.0)),
        skip_conditioning=cfg.get("skip_conditioning"),
        feature_conditioning=cfg.get("feature_conditioning"),
        feature_conditioning_params=cfg.get("feature_conditioning_params"),
        bottleneck_classification=cfg.get("bottleneck_classification", False),
        deep_supervision=cfg.get("deep_supervision", False),
    )


def _swin_kwargs(cfg: Dict[str, Any], n_classes: int) -> Dict[str, Any]:
    """As the JAX factory reads ``sample_configs/unet-swin.yaml``:
    ``embedding_size`` may be a per-stage list (its first entry the
    embedding width, its length the stage count) and ``n_heads`` a scalar
    for every stage. Like the JAX factory it passes no ``activation_fn``,
    ``link_type`` or ``depth``: SWIN-UNet runs its default swish."""
    embed = cfg.get("embed_dim", cfg.get("embedding_size", 24))
    if isinstance(embed, (list, tuple)):
        n_stages = len(embed)
        embed = embed[0]
    else:
        n_stages = len(cfg.get("depths", (2, 2, 2)))
    depths = tuple(cfg.get("depths", (2,) * n_stages))
    heads = cfg.get("n_heads", cfg.get("num_heads"))
    if heads is None:
        heads = tuple(3 * (2 ** i) for i in range(len(depths)))
    if isinstance(heads, int):
        heads = (heads,) * len(depths)
    if len(heads) != len(depths):
        raise ValueError(
            f"n_heads ({list(heads)}) must have one entry per stage "
            f"({len(depths)})"
        )
    return dict(
        in_channels=int(cfg.get("n_channels", 1)),
        spatial_dimensions=cfg.get("spatial_dimensions", 3),
        n_classes=n_classes,
        embed_dim=embed,
        depths=depths,
        n_heads=tuple(heads),
        window_size=tuple(cfg.get("window_size", (4, 4, 4))),
        patch_size=tuple(cfg.get("patch_size", (2, 2, 2))),
        norm_type=cfg.get("norm_type", "instance"),
        dropout_param=cfg.get("dropout_param", cfg.get("dropout_rate", 0.0)),
        skip_conditioning=cfg.get("skip_conditioning"),
        feature_conditioning=cfg.get("feature_conditioning"),
        feature_conditioning_params=cfg.get("feature_conditioning_params"),
        bottleneck_classification=cfg.get("bottleneck_classification", False),
        deep_supervision=cfg.get("deep_supervision", False),
    )


def get_segmentation_network(
    net_type: str,
    network_config: Dict[str, Any],
    n_classes: int = 2,
    image_size: Optional[Sequence[int]] = None,
):
    """``image_size``: the spatial size of the volumes the network will
    see; UNETR is built for it, the U-Net and SWIN-UNet ignore it."""
    if net_type == "unet":
        return UNet(**_unet_kwargs(dict(network_config), n_classes))
    if net_type in ("unetr", "monai_unetr"):
        if image_size is None:
            raise ValueError(
                f"net_type {net_type!r} needs image_size: its positional "
                "embedding fixes the token count"
            )
        return UNETR(
            image_size=tuple(image_size),
            **_unetr_kwargs(dict(network_config), n_classes),
        )
    if net_type in ("swin", "monai_swin"):
        return SWINUNet(**_swin_kwargs(dict(network_config), n_classes))
    raise NotImplementedError(
        f"segmentation net_type {net_type!r} is not ported yet (the port "
        "has 'unet', 'unetr', 'monai_unetr', 'swin' and 'monai_swin')"
    )
