"""
``python -m adell_mri_torch ssl model_to_export`` (and its spelling
``model_to_torchscript``): a trained self-supervised network as one
standalone ``torch.export`` artifact.

Counterpart of ``adell_mri_tpu/entrypoints/ssl/model_to_export.py``: the
network rebuilt from ``--checkpoint_dir``'s ``metadata.json``, its
weights and running statistics from ``model.pt`` (the JAX exporter
restores the ``variables`` beside the ``params``), traced in eval mode
for an f32 input ``[--batch_size or 1, *target_size, 1]`` (64x64x32
where the metadata has no size) and written to ``--output_path`` with its
JSON sidecar (``input_shape``, ``input_dtype``, ``ssl_method``,
``transform_arguments``) by ``train/export.py``. The artifact returns
the network's default output: the prediction head's for the two-view
methods, DINO's prototype logits and iBOT's mean token logits (the first
of its outputs, as the JAX exporter takes it). DINO's and iBOT's centres,
kept beside the weights, are not part of the network. I-JEPA and MAE are
refused: the JAX exporter applies them without the masking stream their
forwards draw from (``InvalidRngError``). VICRegL is refused: the JAX
exporter's artifact ends in a prediction head that a VICRegL checkpoint
does not hold, drawn afresh from ``PRNGKey(0)`` (ROADMAP Queue 3).
``--dev`` (cuda unless ``cpu``) is where the model is traced.
"""

from adell_mri_torch.config.factories import get_ssl_network
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.export import export_model
from adell_mri_torch.train.ssl_steps import without_centres

ARG_KEYS = [
    "checkpoint_dir",
    "checkpoint_name",
    "output_path",
    "ssl_method",
    "batch_size",
    "dev",
]


def main(arguments):
    parser = Parser(prog="adell ssl model_to_export")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    device = use_device(args.dev)
    mngr = CheckpointManager(
        args.checkpoint_dir, name=args.checkpoint_name or
        f"ssl_{args.ssl_method}", fold=0)
    metadata = mngr.load_metadata()
    method = metadata.get("ssl_method", args.ssl_method)
    if method in ("ijepa", "mae"):
        name = "an I-JEPA" if method == "ijepa" else "an MAE"
        raise NotImplementedError(
            f"ssl model_to_export of {name} checkpoint: the JAX exporter "
            "applies the network without the masking stream its forward "
            "draws from (ROADMAP Queue 3)")
    if method == "vicregl":
        raise NotImplementedError(
            "ssl model_to_export of a VICRegL checkpoint: the JAX exporter "
            "appends a prediction head that the checkpoint does not hold, "
            "drawn from PRNGKey(0) (ROADMAP Queue 3)")
    t_args = metadata.get("transform_arguments", {})
    n_channels = len(t_args.get("image_keys") or [1]) * (
        t_args.get("sample_channels") or 1)
    if n_channels != 1:
        raise ValueError(
            f"ssl model_to_export exports a 1-channel input, as the JAX "
            f"exporter does; the checkpoint was trained with {n_channels}")
    size = tuple(t_args.get("target_size") or (64, 64, 32))
    model = get_ssl_network(method, metadata.get("network_config", {}),
                            image_size=size)
    model.load_state_dict(without_centres(mngr.load_state_dict()))
    export_model(
        model.to(device), (args.batch_size or 1,) + size + (1,),
        args.output_path,
        metadata={"ssl_method": method, "transform_arguments": t_args},
        forward=(lambda m, x: m(x)[0]) if method == "ibot" else None)
