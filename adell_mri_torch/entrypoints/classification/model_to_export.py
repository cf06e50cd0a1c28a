"""
``python -m adell_mri_torch classification model_to_export`` (and its
spelling ``model_to_torchscript``): a trained classifier as one
standalone ``torch.export`` artifact.

Counterpart of ``adell_mri_tpu/entrypoints/classification/
model_to_export.py``: the network rebuilt from ``--checkpoint_dir``'s
``metadata.json``, its best weights from ``model.pt``, traced for an f32
input ``[--batch_size, *target_size, n_image_keys]`` and written to
``--output_path`` with its JSON sidecar (``input_shape``,
``input_dtype``, ``net_type``, ``n_classes``, ``transform_arguments``)
by ``train/export.py``. As the JAX exporter applies the parameters
alone, so does the artifact: its batch norms normalise by the batch it
is given (``batch_statistics_mode``; one element a feature by (0, 1)),
not by the running statistics that ``test`` and ``predict`` serve with.
The JAX exporter takes no ``--batch_size`` default (its shape starts with
None, and it fails there): neither does this one. A checkpoint trained
with clinical features is refused (the JAX exporter builds the network
without them). ``--dev`` (cuda unless ``cpu``) is where the model is
traced, and where the artifact's weights live.
"""

from adell_mri_torch.config.factories import get_classification_network
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.models.layers.adn import batch_statistics_mode
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.export import export_model

ARG_KEYS = [
    "checkpoint_dir",
    "checkpoint_name",
    "n_classes",
    "output_path",
    "classification_net_type",
    "batch_size",
    "dev",
]


def _parameters_alone(model, x):
    with batch_statistics_mode(model):
        return model(x)


def main(arguments):
    parser = Parser(prog="adell classification model_to_export")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    if args.batch_size is None:
        raise TypeError("classification model_to_export needs --batch_size "
                        "(the JAX exporter's input shape has no default)")
    device = use_device(args.dev)
    mngr = CheckpointManager(
        args.checkpoint_dir, name=args.checkpoint_name or "classification",
        fold=0)
    metadata = mngr.load_metadata()
    t_args = metadata.get("transform_arguments", {})
    if t_args.get("clinical_feature_keys"):
        raise ValueError(
            "classification model_to_export: the checkpoint was trained with "
            "clinical features, which the exported forward does not take")
    n_classes = metadata.get("n_classes", args.n_classes)
    net_type = metadata.get("net_type", args.classification_net_type)
    image_keys = t_args.get("image_keys", ["image"])
    size = tuple(t_args.get("target_size"))
    model = get_classification_network(
        net_type, metadata.get("network_config", {}), n_classes=n_classes,
        in_channels=len(image_keys), image_size=size)
    model.load_state_dict(mngr.load_state_dict())
    export_model(
        model.to(device), (args.batch_size,) + size + (len(image_keys),),
        args.output_path,
        metadata={"net_type": net_type, "n_classes": n_classes,
                  "transform_arguments": t_args},
        forward=_parameters_alone)
