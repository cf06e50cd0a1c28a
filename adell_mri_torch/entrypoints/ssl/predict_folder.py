"""
``python -m adell_mri_torch ssl predict_folder``: a trained self-supervised
encoder over a folder of volumes, each one's representation written to
JSON.

Counterpart of ``adell_mri_tpu/entrypoints/ssl/predict_folder.py``: the
checkpoint's ``metadata.json`` rebuilds the network; each ``.nii.gz`` and
``.nii`` of ``--input_folder``, in sorted order, is read, oriented to RAS,
resampled to the checkpoint's spacing and size, min-max scaled and encoded
in f32 (``ret="representation"``: the backbone's pooled features); the
JSON maps each file name to ``{"features": [...]}`` rounded to 4
decimals. A VICRegL checkpoint serves the same pooled features. I-JEPA,
DINO, iBOT and MAE checkpoints are refused: the JAX CLI asks each for
``ret="representation"``, a keyword none of their ``__call__``s takes, and
fails with a ``TypeError`` (ROADMAP Queue 3). 4D volumes are not ported
yet.
"""

import glob
import json
import logging
import os

import torch

from adell_mri_torch.config.factories import get_ssl_network
from adell_mri_torch.data.nifti import read_nifti, reorient_to_ras
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.ssl_steps import without_centres
from adell_mri_torch.transforms.host import resample_to_spec

logger = logging.getLogger(__name__)

#: the methods whose networks the JAX CLI cannot ask for a representation
REFUSED = {"ijepa": "an I-JEPA", "dino": "a DINO", "ibot": "an iBOT",
           "mae": "an MAE"}

ARG_KEYS = [
    "checkpoint_dir",
    "checkpoint_name",
    "output_path",
    "dev",
    "seed",
    "ssl_method",
]


def main(arguments):
    parser = Parser(prog="adell ssl predict_folder")
    parser.add_argument_by_key(ARG_KEYS)
    parser.add_argument(
        "--input_folder", required=True, help="Folder with .nii/.nii.gz")
    args = parser.parse_args(arguments)
    device = use_device(args.dev)

    mngr = CheckpointManager(
        args.checkpoint_dir,
        name=args.checkpoint_name or f"ssl_{args.ssl_method}",
        fold=0,
    )
    metadata = mngr.load_metadata()
    method = metadata.get("ssl_method", args.ssl_method)
    if method in REFUSED:
        raise NotImplementedError(
            f"ssl predict_folder on {REFUSED[method]} checkpoint: the JAX "
            "CLI asks the network for ret='representation', which its "
            "__call__ does not take (ROADMAP Queue 3)")
    net_cfg = metadata.get("network_config", {})
    t_args = metadata.get("transform_arguments", {})
    size = tuple(t_args.get("target_size") or (64, 64, 32))
    spacing = t_args.get("target_spacing")
    n_channels = len(t_args.get("image_keys") or [1]) * (
        t_args.get("sample_channels") or 1)

    model = get_ssl_network(method, net_cfg, in_channels=n_channels,
                            image_size=size)
    model.load_state_dict(without_centres(mngr.load_state_dict()))
    model = model.to(device).eval()

    paths = sorted(
        glob.glob(os.path.join(args.input_folder, "*.nii.gz"))
        + glob.glob(os.path.join(args.input_folder, "*.nii")))
    out = {}
    for path in paths:
        img = reorient_to_ras(read_nifti(path))
        if img.data.ndim > 3:
            raise NotImplementedError(
                f"{path}: 4D NIfTI inputs are not ported yet")
        vol = resample_to_spec(img, spacing, size)[..., None]
        if n_channels > 1:
            raise ValueError(
                f"{path} has 1 channel; the checkpoint was trained with "
                f"{n_channels}")
        lo, hi = vol.min(), vol.max()
        vol = (vol - lo) / max(hi - lo, 1e-6)
        x = torch.from_numpy(vol[None]).to(device)
        with torch.inference_mode():
            f = model(x, ret="representation")[0].float().cpu().numpy()
        out[os.path.basename(path)] = {
            "features": [round(float(v), 4) for v in f.ravel()]}
        logger.info("encoded %s -> %d dims", path, f.size)
    with open(args.output_path, "w") as fjson:
        json.dump(out, fjson, indent=1)
    logger.info("wrote %d feature vectors to %s", len(out),
                args.output_path)
