"""Classification mode dispatch: ``train``, ``test``, ``predict`` and
``model_to_export`` (also under the spelling ``model_to_torchscript``)."""

import importlib

supported_modes = {
    "predict": "adell_mri_torch.entrypoints.classification.predict",
    "test": "adell_mri_torch.entrypoints.classification.test",
    "train": "adell_mri_torch.entrypoints.classification.train",
    "model_to_export":
        "adell_mri_torch.entrypoints.classification.model_to_export",
    "model_to_torchscript":
        "adell_mri_torch.entrypoints.classification.model_to_export",
}


def main(arguments):
    if len(arguments) == 0 or arguments[0] in ("help", "--help", "-h"):
        print(f"\n\tSupported modes: {sorted(supported_modes)}")
        return
    mode = arguments[0]
    if mode not in supported_modes:
        raise NotImplementedError(
            f"\n\tMode {mode} not supported (yet)\n\t"
            f"Supported modes: {sorted(supported_modes)}"
        )
    importlib.import_module(supported_modes[mode]).main(arguments[1:])
