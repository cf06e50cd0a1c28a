"""
The serving cases and training steps at full width, shared by
``chip_smoke.py`` and the profilers. ``name`` picks the model.

``"unet"``, the flagship U-Net (``bench.py``'s configuration). Serving:
bf16 with weights drawn from a seed, a 256x256x64 single-channel case
through ``SegmentationInference`` with a 128x128x32 window at stride 0.5
in micro-batches of 4: 27 tiles in 7 window batches. Training: f32 master
weights from a seed, a batch of 4 volumes of 128x128x32 made on the card,
the default ``dice`` loss.

``"unetr"``, ``sample_configs/unetr.yaml`` as it stands (patch 16x16x8,
embedding 512, 8 blocks, 8 heads, all of it) on 256x256x64 inputs: 2048
tokens, the count from which attention goes to the flash kernels.
Serving: bf16, the whole case as one window (the positional embedding
fixes the token count). Training: 2 whole volumes, the yaml's dice + focal
loss, and ``dropout_rate`` 0: with dropout on, attention in training mode
leaves the kernels for the materialised softmax, as in the JAX package.

``"swin"``, ``sample_configs/unet-swin.yaml`` as it stands (patch 4,
window 8x8x8, embeddings 32, 64, 128 and 256, 8 heads a stage), dropout
0 unless asked for. Serving: as the U-Net's (SWIN-UNet takes any input
size). Training: 2 volumes of 128x128x32, the yaml's dice + focal loss.

``"resnet"``, ``sample_configs/u-net-3d-resnet.yaml`` as it stands
(``conv_type: resnet``, depth 32, 32, 64, 128, 256, dropout 0.15 unless
overridden): served as the flagship U-Net; trained at the yaml's batch
of 2 volumes of 128x128x32 with its dice + focal loss.

``"catnet"``, the classifier of ``sample_configs/classification-cat-
resnet.yaml`` as it stands (four ResNet stages, batch ensembles of 4,
batch norm): trained at the yaml's 16 crops of 128x128x32 with binary
labels (``make_catnet_batch``; ``make_catnet_trainer``), the binary
logistic loss and the classifier's ranges of the CLI's augmentation.
The other classifiers (``CLASSIFIERS``) go through the same helpers:
``"catnet_convnext"`` (``classification-cat-convnext.yaml``: four stages
of ConvNeXt blocks, batch ensembles of 4; the yaml's 16 crops), ``"vgg"``
(``vggnet-net.yaml``: the factory's VGG, first depth 16, four blocks,
batch norm; the yaml's 16 crops) and ``"convnext"`` (the standalone
ConvNeXt at the factory's defaults, ``convnext_backbone``; no yaml, so
the CLI's default batch of 4 crops), ``"vit"``
(``classification-vit.yaml`` as it stands: 16x16x4 patches, 768 wide, 10
blocks of 12 heads, MLP [1024], dropout 0.1; built for, served and
trained on whole 256x256x64 volumes: 4096 patch tokens and the class
token, at or above the count from which attention takes the flash
kernels, in batches of 2; ``overrides`` of ``{"dropout_rate": 0}`` keep
a training step on the kernels), ``"vit_crops"`` (the same yaml on
128x128x32 crops at the CLI's default batch of 4: 513 tokens, the
materialised softmax), ``"factorized_vit"`` (the factory's defaults:
4x4 patches a slice, 256 wide, 4 blocks of 4 heads; the CLI's batch of
4), ``"ord"`` (OrdNet over ``classification-cat-resnet.yaml``'s
structure with 3 classes and the ordinal sigmoidal loss; the yaml's 16
crops), ``"unet_classifier"`` (the U-Net encoder classifier of
``u-net-3d-resnet.yaml``; the yaml's 2 crops) and ``"catnet_gp"``
(``classification-cat-resnet.yaml`` with ``gaussian_process: true``
(``CLASSIFIER_OVERRIDES``): the GP head in place of the output layer;
the yaml's 16 crops).

``"encoder_unet"``, the flagship U-Net fine-tuned from a self-supervised
encoder: ``segmentation train --res_config_file
sample_configs/ssl-resnet.yaml`` grafts that yaml's backbone (four ResNet
stages of 64 to 512, pools 2x2x1, 2x2x1, 2x2x2, 2x2x2) as the encoder
(depth 64, 64, 128, 256, 512; strides 2, then the pools), with the
backbone's batch norm; the rest is the flagship's (residual links,
transposed upsampling, swish). Served and trained as the flagship U-Net.

``make_mil_model``: the ``classification_mil`` CLI's model for
``sample_configs/transformable-transformer.yaml`` (``--mil_method
standard`` or ``transformer``: a 2D VGG slice encoder of first depth 16
and 3 blocks, instance norm, then the attention head or 2 transformer
blocks of 16 heads over 64-wide slice tokens), on the CLI's batch of 4
volumes of 256x256x64 (``MIL_BATCH``, ``CASE``): 256 slices of 256x256
a step, 64 tokens a volume.

``"ssl"``, ``sample_configs/ssl-resnet.yaml`` as it stands (the two-view
methods' CatNet backbone: four ResNet stages of 64 to 512, batch norm;
projection 1024, 512, 256; prediction 512, 256): pretrained on the yaml's
28 volumes of 128x128x32 (``make_ssl_batch``), each step two views of
96x96x24 a volume (``SSLTransforms``), AdamW at the yaml's rate and
decay with the norms and biases not decayed (``make_ssl_trainer``; the
method ``vicreg`` by default, ``byol`` with its EMA teacher). ``"ijepa"``,
I-JEPA at the factory's defaults (patch 4, embedding 192, 4 blocks of 4
heads, predictor 96 x 2) on the whole 128x128x32 volume: 8192 tokens.

The supervised models train with the CLI's augmentation (``--augment
intensity noise affine flip``: for the segmentation nets rotation-only
affine, flips on all three axes), Nesterov SGD (momentum 0.99) under
cosine annealing, bf16 or f32 compute.
``overrides`` change keys of a model's network config (e.g. the yaml's
dropout, or ``deep_supervision``; the trainer's step takes the heads the
model carries).
"""

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

from adell_mri_torch.config.factories import (
    get_classification_network,
    get_segmentation_network,
    get_ssl_network,
)
from adell_mri_torch.config.parsing import (
    build_compound_loss,
    load_yaml,
    parse_config_2d_classifier_3d,
    parse_config_cat,
    parse_config_ssl,
    parse_config_unet,
    resnet_encoder_config,
)
from adell_mri_torch.inference import SegmentationInference
from adell_mri_torch.models.classification.losses import (
    binary_logistic_loss,
    cross_entropy_loss,
    ordinal_sigmoidal_loss,
)
from adell_mri_torch.models.layers.adn import (
    pop_batch_stats,
    statistics_to_f32,
)
from adell_mri_torch.models.layers.dropout import seed_dropout
from adell_mri_torch.train.optim import get_optimizer
from adell_mri_torch.train.schedules import cosine_annealing_with_warmup
from adell_mri_torch.train.ssl_steps import (
    EMA_METHODS,
    IMAGE_METHODS,
    initial_centres,
    make_method_step,
    make_ssl_train_step,
)
from adell_mri_torch.train.state import TrainState
from adell_mri_torch.train.steps import (
    make_classification_step,
    make_eval_step,
    make_segmentation_step,
    make_train_step,
)
from adell_mri_torch.transforms.pipeline import (
    AugmentPolicy,
    ClassificationTransforms,
    SegmentationTransforms,
    SSLTransforms,
)

FLAGSHIP = dict(
    spatial_dimensions=3,
    conv_type="regular",
    link_type="residual",
    upscale_type="transpose",
    norm_type="instance",
    activation_fn="swish",
    dropout_param=0.0,
    depth=[32, 32, 64, 128, 256],
    kernel_sizes=[3, 3, 3, 3, 3],
    strides=[2, 2, 2, 2, 2],
)
WINDOW = (128, 128, 32)
CASE = (256, 256, 64)
BATCH = 4
UNETR_YAML = (
    Path(__file__).resolve().parents[2] / "sample_configs" / "unetr.yaml"
)
UNETR_BATCH = 2
SWIN_YAML = UNETR_YAML.with_name("unet-swin.yaml")
SWIN_BATCH = 2
RESNET_YAML = UNETR_YAML.with_name("u-net-3d-resnet.yaml")
RESNET_BATCH = 2
CATNET_YAML = UNETR_YAML.with_name("classification-cat-resnet.yaml")
CATNET_BATCH = 16
SSL_YAML = UNETR_YAML.with_name("ssl-resnet.yaml")
SSL_SHAPE = (128, 128, 32)
SSL_VIEW = (96, 96, 24)
SSL_T_MAX = 100  # the schedule's and the EMA ramp's length in steps
SSL_LOCAL_CROPS = 4  # DINO's local crops a sample, 48x48x12
MIL_YAML = UNETR_YAML.with_name("transformable-transformer.yaml")
MIL_BATCH = 4  # the classification_mil CLI's default batch
# name -> (the CLI's --classification_net_type, the yaml or None for the
# factory's defaults, the training batch: the yaml's, else the CLI's 4)
CLASSIFIERS = {
    "catnet": ("cat", CATNET_YAML, CATNET_BATCH),
    "catnet_convnext": (
        "cat", UNETR_YAML.with_name("classification-cat-convnext.yaml"), 16),
    "vgg": ("vgg", UNETR_YAML.with_name("vggnet-net.yaml"), 16),
    "convnext": ("convnext_backbone", None, 4),
    "vit": ("vit", UNETR_YAML.with_name("classification-vit.yaml"), 2),
    "vit_crops": ("vit", UNETR_YAML.with_name("classification-vit.yaml"),
                  4),
    "factorized_vit": ("factorized_vit", None, 4),
    "ord": ("ord", CATNET_YAML, CATNET_BATCH),
    "unet_classifier": ("unet", RESNET_YAML, RESNET_BATCH),
    "catnet_gp": ("cat", CATNET_YAML, CATNET_BATCH),
}
# keys that a classifier's yaml does not hold
CLASSIFIER_OVERRIDES = {"catnet_gp": {"gaussian_process": True}}
# the classifiers' input size where it is not WINDOW, and their number of
# classes where it is not 2
CLASSIFIER_SHAPES = {"vit": CASE}
CLASSIFIER_CLASSES = {"ord": 3}


def classifier_shape(name: str) -> tuple:
    return CLASSIFIER_SHAPES.get(name, WINDOW)


@dataclass(frozen=True)
class ModelSpec:
    net_type: str
    network_config: dict
    loss: dict
    window: tuple  # serving window; also the size of a training volume
    serve_batch: int
    train_batch: int


def model_spec(name: str, overrides: dict = None) -> ModelSpec:
    overrides = overrides or {}
    if name == "unet":
        return ModelSpec("unet", {**FLAGSHIP, **overrides}, {"dice": {}},
                         WINDOW, BATCH, BATCH)
    if name == "encoder_unet":
        network = {**FLAGSHIP, "norm_type": "batch",
                   **resnet_encoder_config(load_yaml(str(SSL_YAML))),
                   **overrides}
        return ModelSpec("unet", network, {"dice": {}}, WINDOW, BATCH, BATCH)
    if name == "resnet":
        config, _ = parse_config_unet(str(RESNET_YAML))
        return ModelSpec("unet", {**config["network"], **overrides},
                         config["training"]["loss_fn"], WINDOW, BATCH,
                         RESNET_BATCH)
    if name in ("unetr", "swin"):
        yaml_path, window, serve, train = (
            (UNETR_YAML, CASE, 1, UNETR_BATCH) if name == "unetr"
            else (SWIN_YAML, WINDOW, BATCH, SWIN_BATCH))
        config, _ = parse_config_unet(str(yaml_path))
        network = {**config["network"], "dropout_rate": 0.0, **overrides}
        return ModelSpec(name, network, config["training"]["loss_fn"],
                         window, serve, train)
    raise ValueError(f"unknown model {name!r}: 'unet', 'encoder_unet', "
                     "'resnet', 'unetr' or 'swin'")


def _network(spec: ModelSpec):
    return get_segmentation_network(
        spec.net_type, spec.network_config, n_classes=2,
        image_size=spec.window,
    )


def make_model(seed: int, dtype, device="cuda", name: str = "unet",
               overrides: dict = None):
    """The model with weights drawn from ``seed``, in eval mode (running
    statistics f32, as the CLI holds them)."""
    torch.manual_seed(seed)
    return statistics_to_f32(_network(model_spec(name, overrides)).to(
        device=device, dtype=dtype)).eval()


def make_case(seed: int, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(CASE + (1,), generator=g, device=device)


def make_inference(model, name: str = "unet"):
    spec = model_spec(name)
    dtype = next(model.parameters()).dtype
    return SegmentationInference(
        lambda m, x: m(x.to(dtype), heads=False).float(), [model],
        sliding_window_size=spec.window, stride=0.5,
        batch_size=spec.serve_batch,
    )


AUGMENT_FLAGS = ("intensity", "noise", "affine", "flip")


def make_train_batch(seed: int, device="cuda", batch=BATCH, shape=WINDOW):
    """A learnable synthetic batch on the card: per volume a bright
    ellipsoid (the label) at a random centre over a noisy background,
    min-max scaled as the loader scales images. image [B, *shape, 1],
    label [B, *shape]."""
    g = torch.Generator(device=device).manual_seed(seed)
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(s, device=device, dtype=torch.float32)
          for s in shape], indexing="ij"), -1)
    size = torch.tensor(shape, device=device, dtype=torch.float32)
    centres = size * (0.35 + 0.3 * torch.rand((batch, 3), generator=g,
                                              device=device))
    radii = size / 5
    dist = (((grid[None] - centres[:, None, None, None]) / radii) ** 2)
    label = (dist.sum(-1) <= 1.0).float()
    noise = torch.randn((batch,) + tuple(shape), generator=g, device=device)
    image = 0.3 + 0.4 * label + 0.1 * noise
    lo = image.amin(dim=(1, 2, 3), keepdim=True)
    hi = image.amax(dim=(1, 2, 3), keepdim=True)
    return {"image": ((image - lo) / (hi - lo))[..., None], "label": label}


@dataclass
class Trainer:
    state: TrainState
    train_step: Callable
    eval_step: Callable
    loss_and_metrics: Callable
    transforms: Any  # SegmentationTransforms or ClassificationTransforms
    model: torch.nn.Module


def make_trainer(seed: int, precision: str, device="cuda",
                 learning_rate: float = 1e-3, t_max: int = 100,
                 name: str = "unet", overrides: dict = None):
    """The model (f32 master weights from ``seed``) with its train and
    eval steps, optimizer and augmentation."""
    spec = model_spec(name, overrides)
    torch.manual_seed(seed)
    model = _network(spec).to(device)
    loss_fn = build_compound_loss(spec.loss, n_classes=2)
    schedule = cosine_annealing_with_warmup(learning_rate, t_max=t_max)
    state = TrainState.create(
        model, lambda p: get_optimizer("sgd", schedule, params=p)
    )
    lm = make_segmentation_step(model, loss_fn, precision=precision)
    eval_lm = make_segmentation_step(model, loss_fn, train=False,
                                     precision=precision)
    transforms = SegmentationTransforms(
        augmentations=AugmentPolicy.from_flags(
            AUGMENT_FLAGS, scale_range=0.0, flip_axes=(0, 1, 2)
        )
    )
    return Trainer(state, make_train_step(lm), make_eval_step(eval_lm), lm,
                   transforms, model)


def make_catnet(seed: int, device="cuda", name: str = "catnet",
                overrides: dict = None):
    """The classifier ``name`` (``CLASSIFIERS``; ``overrides`` change keys
    of its network config) with f32 weights drawn from ``seed``, in
    training mode, built for ``classifier_shape(name)``."""
    net_type, yaml_path, _ = CLASSIFIERS[name]
    torch.manual_seed(seed)
    network = (parse_config_cat(str(yaml_path))["network"] if yaml_path
               else {})
    return get_classification_network(
        net_type, {**network, **CLASSIFIER_OVERRIDES.get(name, {}),
                   **(overrides or {})},
        n_classes=CLASSIFIER_CLASSES.get(name, 2),
        image_size=classifier_shape(name)).to(device)


def make_served_classifier(seed: int, device="cuda", name: str = "catnet"):
    """The classifier ``name`` (``make_catnet``) in eval mode, with the
    running statistics of two training forwards on 4 inputs of its size
    (``make_catnet_batch(seed + 1)``; 2 at 256x256x64): a served model's
    statistics."""
    model = make_catnet(seed, device, name)
    shape = classifier_shape(name)
    crops = make_catnet_batch(seed + 1, device, batch=4 if shape == WINDOW
                              else 2, shape=shape)["image"]
    with torch.no_grad():
        buffers = dict(model.named_buffers())
        for _ in range(2):
            model(crops)
            for k, v in pop_batch_stats(model).items():
                buffers[k].copy_(v)
    return model.eval()


def make_catnet_batch(seed: int, device="cuda", batch=CATNET_BATCH,
                      shape=WINDOW, n_classes: int = 2):
    """A learnable classification batch on the card: noise around 0.3 and,
    in the positives (label ``i % n_classes`` of sample ``i`` above 0), an
    ellipsoid at a random centre, the brighter the higher the label;
    min-max scaled as the loader scales images. image [B, *shape, 1],
    label [B]."""
    g = torch.Generator(device=device).manual_seed(seed)
    label = (torch.arange(batch, device=device) % n_classes).float()
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(s, device=device, dtype=torch.float32)
          for s in shape], indexing="ij"), -1)
    size = torch.tensor(shape, device=device, dtype=torch.float32)
    centres = size * (0.35 + 0.3 * torch.rand((batch, 3), generator=g,
                                              device=device))
    dist = (((grid[None] - centres[:, None, None, None]) / (size / 6)) ** 2)
    blob = (dist.sum(-1) <= 1.0).float() * (
        label / (n_classes - 1))[:, None, None, None]
    image = 0.3 + 0.4 * blob + 0.1 * torch.randn(
        (batch,) + tuple(shape), generator=g, device=device)
    lo = image.amin(dim=(1, 2, 3), keepdim=True)
    hi = image.amax(dim=(1, 2, 3), keepdim=True)
    return {"image": ((image - lo) / (hi - lo))[..., None], "label": label}


def classifier_loss(name: str):
    """The loss ``classification train`` takes for ``name``: the ordinal
    sigmoidal loss for OrdNet, else the binary logistic or the cross
    entropy by the number of classes."""
    n_classes = CLASSIFIER_CLASSES.get(name, 2)
    if CLASSIFIERS[name][0] == "ord":
        return lambda logits, y: ordinal_sigmoidal_loss(logits, y,
                                                        n_classes)
    return binary_logistic_loss if n_classes == 2 else cross_entropy_loss


def make_catnet_trainer(seed: int, precision: str, device="cuda",
                        learning_rate: float = 1e-3, t_max: int = 100,
                        name: str = "catnet", overrides: dict = None):
    """The classifier ``name`` (f32 master weights from ``seed``, its
    members and dropout drawn from a generator seeded alike; ``overrides``
    as ``make_catnet``) with its train and eval steps on its loss
    (``classifier_loss``), Nesterov SGD and the classification CLI's
    augmentation policy (``AugmentPolicy.classification``) at its
    size."""
    model = make_catnet(seed, device, name, overrides)
    seed_dropout(model, torch.Generator(device=device).manual_seed(seed))
    schedule = cosine_annealing_with_warmup(learning_rate, t_max=t_max)
    state = TrainState.create(
        model, lambda p: get_optimizer("sgd", schedule, params=p))
    loss_fn, n_classes = classifier_loss(name), CLASSIFIER_CLASSES.get(
        name, 2)
    lm = make_classification_step(model, loss_fn, n_classes=n_classes,
                                  precision=precision)
    eval_lm = make_classification_step(model, loss_fn, n_classes=n_classes,
                                       train=False, precision=precision)
    transforms = ClassificationTransforms(
        augmentations=AugmentPolicy.classification(
            AUGMENT_FLAGS, classifier_shape(name)))
    return Trainer(state, make_train_step(lm), make_eval_step(eval_lm), lm,
                   transforms, model)


def ssl_training_config(method: str = "vicreg"):
    """(network config, training config) of ``ssl-resnet.yaml``: the
    network keys for the two-view methods; I-JEPA takes the factory's
    defaults and the yaml's training keys (batch 28, rate 0.01, decay
    0.001)."""
    config = parse_config_ssl(str(SSL_YAML), is_ijepa=method == "ijepa")
    network = {} if method == "ijepa" else config["network"]
    return network, config["training"]


def make_ssl_model(seed: int, method: str = "vicreg", device="cuda"):
    """The network of ``method`` with f32 weights drawn from ``seed``, in
    training mode: built for the views (DINO, iBOT) or the volume."""
    torch.manual_seed(seed)
    network, _ = ssl_training_config(method)
    size = SSL_VIEW if method in ("dino", "ibot") else SSL_SHAPE
    return get_ssl_network(method, network, image_size=size).to(device)


def make_served_ssl(seed: int, device="cuda"):
    """The two-view network (``make_ssl_model``) in eval mode, with the
    running statistics of two training forwards on 4 volumes of
    128x128x32 (``make_ssl_batch(seed + 1)``): a served encoder."""
    model = make_ssl_model(seed, device=device)
    volumes = make_ssl_batch(seed + 1, device, batch=4)["image"]
    with torch.no_grad():
        buffers = dict(model.named_buffers())
        for _ in range(2):
            model(volumes, ret="representation")
            for k, v in pop_batch_stats(model).items():
                buffers[k].copy_(v)
    return model.eval()


def make_ssl_batch(seed: int, device="cuda", batch=None, shape=SSL_SHAPE):
    """``batch`` (the yaml's 28 by default) volumes on the card: noise
    around 0.3 with a bright ellipsoid in every other one, min-max scaled
    as the loader scales images; ``image`` [B, *shape, 1]."""
    if batch is None:
        batch = ssl_training_config()[1]["batch_size"]
    return {"image": make_catnet_batch(seed, device, batch, shape)["image"]}


def make_ssl_trainer(seed: int, precision: str, method: str = "vicreg",
                     device="cuda", learning_rate=None):
    """``method``'s network (``make_ssl_model``) with its train step
    (``make_method_step``: the masks and noise draw from a generator
    seeded with ``seed``), AdamW at the yaml's rate (or
    ``learning_rate``) and decay with the norms and biases not decayed,
    under cosine annealing over ``SSL_T_MAX`` steps, for ``EMA_METHODS``
    the EMA shadow (decay 0.996 ramped to 1 over the same steps), DINO's
    and iBOT's centres (zeros); ``transforms`` are the views'
    (``SSLTransforms``, 96x96x24 crops; VICRegL's with their matrices,
    DINO's with ``SSL_LOCAL_CROPS`` local crops), None for MAE and I-JEPA,
    which read the volume itself."""
    model = make_ssl_model(seed, method, device)
    network, training = ssl_training_config(method)
    schedule = cosine_annealing_with_warmup(
        learning_rate or training["learning_rate"], t_max=SSL_T_MAX)
    use_ema = method in EMA_METHODS
    state = TrainState.create(
        model, lambda p: get_optimizer(
            "adamw", schedule, weight_decay=training["weight_decay"],
            params=p, exclude_norms_from_decay=True, model=model),
        with_ema=use_ema, ema_decay=0.996, ema_final_decay=1.0,
        ema_n_steps=SSL_T_MAX)
    state.variables.update(initial_centres(
        method, network.get("out_dim", 4096), device))
    lm = make_method_step(
        model, method, precision,
        generator=torch.Generator(device=device).manual_seed(seed),
        ema_teacher=use_ema)
    transforms = None if method in IMAGE_METHODS else SSLTransforms(
        crop_size=SSL_VIEW, seed=seed, expose_boxes=method == "vicregl",
        n_local_crops=SSL_LOCAL_CROPS if method == "dino" else 0)
    return Trainer(state, make_ssl_train_step(lm), None, lm, transforms,
                   model)


def make_mil_model(seed: int, method: str = "standard", device="cuda"):
    """The MIL model of ``--mil_method method`` for ``MIL_YAML`` (binary),
    f32 weights drawn from ``seed``, in eval mode."""
    from adell_mri_torch.entrypoints.classification_mil.train import (
        build_mil_model,
    )

    config = parse_config_2d_classifier_3d(str(MIL_YAML), mil_method=method)
    torch.manual_seed(seed)
    return build_mil_model(config["network"], method, 2).to(device).eval()


def make_mil_trainer(seed: int, precision: str, method: str = "standard",
                     device="cuda", learning_rate: float = 1e-3,
                     t_max: int = 100):
    """``make_mil_model`` with the CLI's step (the binary logistic loss, no
    augmentation) and optimizer (Nesterov SGD under cosine annealing)."""
    model = make_mil_model(seed, method, device)
    schedule = cosine_annealing_with_warmup(learning_rate, t_max=t_max)
    state = TrainState.create(
        model, lambda p: get_optimizer("sgd", schedule, params=p))
    lm = make_classification_step(model, binary_logistic_loss, 2,
                                  precision=precision)
    eval_lm = make_classification_step(model, binary_logistic_loss, 2,
                                       train=False, precision=precision)
    return Trainer(state, make_train_step(lm), make_eval_step(eval_lm), lm,
                   None, model)
