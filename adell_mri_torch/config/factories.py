"""
Network factory: config dict + net-type string -> the port's module.

Counterpart of ``get_segmentation_network``,
``get_classification_network`` and ``get_ssl_network`` in
``adell_mri_tpu/config/factories.py``,
for the segmentation ``net_type`` "unet", "unetr", "monai_unetr", "swin"
and "monai_swin", every classification ``net_type`` of the JAX CLI
(``CLASSIFICATION_NET_TYPES``), each wrapped in a ``HybridClassifier``
when clinical features are given, and the self-supervised
``ssl_method`` of the JAX CLI (``SSL_METHODS``); the
same config keys, fallbacks and defaults reach the port's ``UNet``,
``UNETR``, ``SWINUNet``, ``VGG``, ``CatNet``, ``ConvNeXt``, ``OrdNet``,
``UNetEncoderClassifier``, ``ViTClassifier``,
``FactorizedViTClassifier`` and the self-supervised networks, which raise
for the options they do not serve yet. A flax module learns its input
size and channels at the first call; the port's UNETR, the two ViT
classifiers and I-JEPA need the size when they are built (``image_size``:
the learnt positional embedding fixes the token count), DINO and iBOT
their global views' size (the size of their buffered positions), UNETR
and SWIN-UNet need ``n_channels`` from the
config, the classifiers and the self-supervised networks their
``in_channels`` (one per image key).
"""

from typing import Any, Dict, Optional, Sequence

from adell_mri_torch.models.classification.nets import (
    VGG,
    CatNet,
    FactorizedViTClassifier,
    HybridClassifier,
    OrdNet,
    UNetEncoderClassifier,
    ViTClassifier,
)
from adell_mri_torch.models.layers.adn import get_adn_fn
from adell_mri_torch.models.layers.conv_next import ConvNeXt
from adell_mri_torch.models.segmentation.unet import UNet
from adell_mri_torch.models.segmentation.unetr import UNETR, SWINUNet
from adell_mri_torch.models.ssl.nets import (
    DINO,
    IBOT,
    IJEPA,
    NonContrastiveWrapper,
    ViTMaskedAutoEncoder,
)


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


#: every choice of the JAX CLI's ``--classification_net_type``
CLASSIFICATION_NET_TYPES = ("cat", "ord", "vgg", "vit", "factorized_vit",
                            "unet", "resnet", "convnext",
                            "convnext_backbone", "convnext_v2")
#: the net types built for one input size
SIZED_NET_TYPES = ("vit", "factorized_vit")


def _structure(cfg, default):
    return [tuple(s) for s in cfg.get("resnet_structure", default)]


def get_classification_network(
    net_type: str,
    network_config: Dict[str, Any],
    n_classes: int = 2,
    in_channels: int = 1,
    clinical_feature_means: Optional[Sequence[float]] = None,
    clinical_feature_stds: Optional[Sequence[float]] = None,
    image_size: Optional[Sequence[int]] = None,
    feature_extraction: bool = False,
):
    """The JAX factory's networks, keys and defaults: ``vgg`` (VGG:
    ``first_depth`` 16, ``n_blocks`` 4, ``norm_type`` "batch"); ``cat``,
    ``resnet`` and ``convnext`` (CatNet: ``resnet_structure``,
    ``maxpool_structure``, ``res_type`` "resnet", or "convnext" for the
    net type ``convnext``, ``batch_ensemble`` 0, ``norm_type`` "batch",
    ``act_fn`` (or ``activation_fn``) "swish", ``dropout_param``,
    ``classification_structure``, ``gaussian_process``, which raises);
    ``convnext_backbone`` and ``convnext_v2`` (ConvNeXt: ``resnet_structure``
    ((64, 64, 7, 2), (128, 128, 7, 2)), ``first_layer_stride`` 4,
    ``maxpool_structure``, ``downsample`` "conv"); ``ord`` (OrdNet:
    ``resnet_structure``, ``norm_type`` "batch", ``dropout_param``; no
    ``maxpool_structure``, ``res_type``, batch ensembles or ``act_fn``
    reach it, so relu); ``vit`` (ViTClassifier: ``patch_size`` (4, 4, 4),
    ``embed_dim`` | ``attention_dim`` | ``embedding_size`` 256,
    ``mlp_structure`` exactly as given, else ``mlp_ratio`` 4,
    ``n_blocks`` | ``number_of_blocks`` 4, ``n_heads`` |
    ``number_of_attention_heads`` 4, ``dropout_param`` | ``dropout_rate``
    0, ``use_class_token`` True, ``use_seq_pool``, ``moe_experts`` (which
    raises), ``embed_method`` "linear", ``embed_norm``);
    ``factorized_vit`` (``patch_size`` (4, 4), ``embed_dim`` |
    ``embedding_size`` 256, ``n_blocks`` 4, ``n_heads`` 4,
    ``dropout_param`` | ``dropout_rate``); ``unet`` (the U-Net of the
    segmentation factory's keys, ``encoder_only``, under a head of
    ``(depth[-1],) * 3`` with a 1-d ADN of ``norm_fn`` "batch", gelu and
    ``dropout_param``). The two ViT classifiers are built for
    ``image_size``. With ``clinical_feature_means`` (and
    ``clinical_feature_stds``) the network is built headless inside a
    ``HybridClassifier`` over that many tabular features; with
    ``feature_extraction`` it is built headless alone (an ensemble's
    member: the JAX ensembles call their members with
    ``return_features``, so flax creates no head)."""
    if net_type not in CLASSIFICATION_NET_TYPES:
        raise NotImplementedError(
            f"classification net_type {net_type!r} is not ported yet (the "
            f"port has {', '.join(map(repr, CLASSIFICATION_NET_TYPES))})"
        )
    if net_type in SIZED_NET_TYPES and image_size is None:
        raise ValueError(
            f"net_type {net_type!r} needs image_size: its positional "
            "embedding fixes the token count")
    cfg = dict(network_config)
    hybrid = clinical_feature_means is not None
    headless = hybrid or feature_extraction
    sd = cfg.get("spatial_dimensions", 3)
    if net_type == "vgg":
        net = VGG(
            in_channels=in_channels,
            spatial_dimensions=sd,
            n_classes=n_classes,
            first_depth=cfg.get("first_depth", 16),
            n_blocks=cfg.get("n_blocks", 4),
            norm_type=cfg.get("norm_type", "batch"),
            feature_extraction=headless,
        )
    elif net_type in ("convnext_backbone", "convnext_v2"):
        net = ConvNeXt(
            in_channels=in_channels,
            structure=_structure(cfg, ((64, 64, 7, 2), (128, 128, 7, 2))),
            n_classes=n_classes,
            first_layer_stride=cfg.get("first_layer_stride", 4),
            maxpool_structure=cfg.get("maxpool_structure"),
            v2=net_type == "convnext_v2",
            downsample=cfg.get("downsample", "conv"),
            feature_extraction=headless,
        )
    elif net_type == "ord":
        net = OrdNet(
            in_channels=in_channels,
            spatial_dimensions=sd,
            n_classes=n_classes,
            resnet_structure=_structure(
                cfg, ((64, 128, 5, 2), (128, 256, 3, 5))),
            norm_type=cfg.get("norm_type", "batch"),
            dropout_param=cfg.get("dropout_param", 0.0),
            feature_extraction=headless,
        )
    elif net_type == "vit":
        mlp = cfg.get("mlp_structure")
        net = ViTClassifier(
            in_channels=in_channels,
            image_size=tuple(image_size),
            patch_size=tuple(cfg.get("patch_size", (4, 4, 4))),
            n_classes=n_classes,
            embed_dim=cfg.get("embed_dim", cfg.get(
                "attention_dim", cfg.get("embedding_size", 256))),
            mlp_structure=tuple(mlp) if mlp else None,
            mlp_ratio=cfg.get("mlp_ratio", 4.0),
            n_blocks=cfg.get("n_blocks", cfg.get("number_of_blocks", 4)),
            n_heads=cfg.get("n_heads",
                            cfg.get("number_of_attention_heads", 4)),
            dropout_param=cfg.get("dropout_param",
                                  cfg.get("dropout_rate", 0.0)),
            use_class_token=cfg.get("use_class_token", True),
            use_seq_pool=cfg.get("use_seq_pool", False),
            moe_experts=cfg.get("moe_experts", 0),
            embed_method=cfg.get("embed_method", "linear"),
            embed_norm=bool(cfg.get("embed_norm", False)),
            feature_extraction=headless,
        )
    elif net_type == "factorized_vit":
        net = FactorizedViTClassifier(
            in_channels=in_channels,
            image_size=tuple(image_size),
            patch_size=tuple(cfg.get("patch_size", (4, 4))),
            n_classes=n_classes,
            embed_dim=cfg.get("embed_dim", cfg.get("embedding_size", 256)),
            n_blocks=cfg.get("n_blocks", 4),
            n_heads=cfg.get("n_heads", 4),
            dropout_param=cfg.get("dropout_param",
                                  cfg.get("dropout_rate", 0.0)),
            feature_extraction=headless,
        )
    elif net_type == "unet":
        kwargs = {**_unet_kwargs(cfg, n_classes), "in_channels": in_channels}
        last = kwargs["depth"][-1]
        net = UNetEncoderClassifier(
            UNet(**kwargs, encoder_only=True), last, n_classes=n_classes,
            head_structure=(last,) * 3,
            head_adn_fn=get_adn_fn(cfg.get("norm_fn", "batch"), "gelu",
                                   cfg.get("dropout_param", 0.0),
                                   spatial_dim=1),
            feature_extraction=headless,
        )
    else:
        mp = cfg.get("maxpool_structure")
        net = CatNet(
            in_channels=in_channels,
            spatial_dimensions=sd,
            n_classes=n_classes,
            resnet_structure=_structure(
                cfg, ((64, 128, 5, 2), (128, 256, 3, 5))),
            maxpool_structure=[
                tuple(s) if isinstance(s, (list, tuple)) else s for s in mp
            ] if mp else None,
            res_type=cfg.get(
                "res_type",
                "convnext" if net_type == "convnext" else "resnet"),
            batch_ensemble=cfg.get("batch_ensemble", 0),
            norm_type=cfg.get("norm_type", "batch"),
            act_fn=cfg.get("act_fn", cfg.get("activation_fn", "swish")),
            dropout_param=cfg.get("dropout_param", 0.0),
            classification_structure=cfg.get("classification_structure"),
            gp_head=bool(cfg.get("gaussian_process", False)),
            feature_extraction=headless,
        )
    if hybrid:
        net = HybridClassifier(
            net, len(clinical_feature_means), n_classes=n_classes,
            tab_mean=list(clinical_feature_means),
            tab_std=list(clinical_feature_stds),
        )
    return net


#: the two-view methods of ``ssl train`` the port runs
SSL_TWO_VIEW = ("vicreg", "barlow_twins", "simclr", "ntxent", "simsiam",
                "byol")
#: the ViT methods
SSL_VIT = ("dino", "ibot", "mae")
SSL_METHODS = SSL_TWO_VIEW + ("vicregl",) + SSL_VIT + ("ijepa",)


def get_ssl_network(
    ssl_method: str,
    network_config: Dict[str, Any],
    in_channels: int = 1,
    image_size: Optional[Sequence[int]] = None,
    feature_extraction: bool = False,
):
    """The JAX factory's networks, keys and defaults: ``ijepa`` (IJEPA:
    ``patch_size`` (4, 4, 4), ``embed_dim`` 192, ``n_blocks`` 4,
    ``n_heads`` 4, ``predictor_dim`` 96, ``predictor_blocks`` 2; built for
    ``image_size``); ``dino`` and ``ibot`` (the same ViT keys and
    defaults, ``out_dim`` 4096, ``hidden_dim`` 512, ``bottleneck_dim`` 128,
    iBOT's ``n_mask_blocks`` 4; built for ``image_size``, the global
    views'); ``mae`` (``decoder_dim`` 96, ``decoder_blocks`` 2,
    ``mask_ratio`` 0.75); ``vicregl`` (the two-view wrapper without its
    prediction head, which the JAX tree of a ``ret="local"`` network
    lacks); the two-view methods (a ``NonContrastiveWrapper``
    over CatNet with ``feature_extraction``), reading
    ``sample_configs/ssl-resnet.yaml``'s nested ``backbone_args``
    (``structure``, ``maxpool_structure``, ``res_type``, ``spatial_dim``),
    ``projection_head_args`` and ``prediction_head_args`` (``structure``)
    and their flat spellings (``backbone_structure`` or
    ``resnet_structure``, ``maxpool_structure``, ``res_type``,
    ``spatial_dimensions``, ``projection_head`` or ``projection_dims``,
    ``prediction_head`` or ``prediction_dims``; the flat ones win), with
    ``norm_type`` (or ``norm_fn``) "batch" and ``dropout_param``. CatNet
    takes its default swish: like the JAX factory this one passes no
    ``act_fn``."""
    cfg = dict(network_config)
    if ssl_method == "ijepa":
        if image_size is None:
            raise ValueError("ijepa needs image_size: its positional "
                             "embedding fixes the token count")
        return IJEPA(
            in_channels=in_channels,
            image_size=tuple(image_size),
            patch_size=tuple(cfg.get("patch_size", (4, 4, 4))),
            embed_dim=cfg.get("embed_dim", 192),
            n_blocks=cfg.get("n_blocks", 4),
            n_heads=cfg.get("n_heads", 4),
            predictor_dim=cfg.get("predictor_dim", 96),
            predictor_blocks=cfg.get("predictor_blocks", 2),
        )
    vit = dict(
        in_channels=in_channels,
        patch_size=tuple(cfg.get("patch_size", (4, 4, 4))),
        embed_dim=cfg.get("embed_dim", 192),
        n_blocks=cfg.get("n_blocks", 4),
        n_heads=cfg.get("n_heads", 4),
    )
    if ssl_method in ("dino", "ibot"):
        if image_size is None:
            raise ValueError(f"{ssl_method} needs image_size (its global "
                             "views' size)")
        head = dict(out_dim=cfg.get("out_dim", 4096),
                    hidden_dim=cfg.get("hidden_dim", 512),
                    bottleneck_dim=cfg.get("bottleneck_dim", 128))
        if ssl_method == "dino":
            return DINO(image_size=tuple(image_size), **vit, **head)
        return IBOT(image_size=tuple(image_size), **vit, **head,
                    n_mask_blocks=cfg.get("n_mask_blocks", 4))
    if ssl_method == "mae":
        return ViTMaskedAutoEncoder(
            **vit,
            decoder_dim=cfg.get("decoder_dim", 96),
            decoder_blocks=cfg.get("decoder_blocks", 2),
            mask_ratio=cfg.get("mask_ratio", 0.75),
        )
    if ssl_method not in SSL_TWO_VIEW + ("vicregl",):
        raise ValueError(f"unknown ssl_method {ssl_method!r} (one of "
                         f"{', '.join(SSL_METHODS)})")
    ba = cfg.get("backbone_args") or {}
    pja = cfg.get("projection_head_args") or {}
    pda = cfg.get("prediction_head_args") or {}
    structure = cfg.get("backbone_structure", cfg.get(
        "resnet_structure",
        ba.get("structure", ((32, 64, 3, 2), (64, 128, 3, 2)))))
    maxpool = cfg.get("maxpool_structure", ba.get("maxpool_structure"))
    backbone = CatNet(
        in_channels=in_channels,
        spatial_dimensions=cfg.get("spatial_dimensions",
                                   ba.get("spatial_dim", 3)),
        resnet_structure=[tuple(s) for s in structure],
        maxpool_structure=[
            tuple(s) if isinstance(s, (list, tuple)) else s for s in maxpool
        ] if maxpool else None,
        res_type=cfg.get("res_type", ba.get("res_type", "resnet")),
        norm_type=cfg.get("norm_type", cfg.get("norm_fn", "batch")),
        dropout_param=cfg.get("dropout_param", 0.0),
        feature_extraction=True,
    )
    return NonContrastiveWrapper(
        backbone,
        projection_dims=tuple(cfg.get("projection_head", cfg.get(
            "projection_dims", pja.get("structure", (512, 128))))),
        prediction_dims=() if ssl_method == "vicregl" else tuple(
            cfg.get("prediction_head", cfg.get(
                "prediction_dims", pda.get("structure", (64, 128))))),
    )
