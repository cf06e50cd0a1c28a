"""
Network factory: config dict + net-type string -> the port's module.

Counterpart of ``get_segmentation_network`` in
``adell_mri_tpu/config/factories.py``, for ``net_type="unet"``; the same
config keys and defaults reach the port's ``UNet``, which raises for the
options it does not serve yet.
"""

from typing import Any, Dict

from adell_mri_torch.models.segmentation.unet import UNet


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


def get_segmentation_network(
    net_type: str, network_config: Dict[str, Any], n_classes: int = 2
):
    if net_type != "unet":
        raise NotImplementedError(
            f"segmentation net_type {net_type!r} is not ported yet (the "
            "port has 'unet')"
        )
    return UNet(**_unet_kwargs(dict(network_config), n_classes))
