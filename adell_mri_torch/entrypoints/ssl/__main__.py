"""Self-supervised mode dispatch: ``train`` (and its old spelling
``train_3d``), ``predict_folder`` and ``model_to_export`` (also under
the spelling ``model_to_torchscript``). ``train_2d`` is not ported yet
(ROADMAP Queue 1, item 4)."""

import importlib

supported_modes = {
    "predict_folder": "adell_mri_torch.entrypoints.ssl.predict_folder",
    "train": "adell_mri_torch.entrypoints.ssl.train",
    "train_3d": "adell_mri_torch.entrypoints.ssl.train",
    "model_to_export": "adell_mri_torch.entrypoints.ssl.model_to_export",
    "model_to_torchscript": "adell_mri_torch.entrypoints.ssl.model_to_export",
}
unported_modes = ("train_2d",)


def main(arguments):
    if len(arguments) == 0 or arguments[0] in ("help", "--help", "-h"):
        print(f"\n\tSupported modes: {sorted(supported_modes)}")
        return
    mode = arguments[0]
    if mode in unported_modes:
        raise NotImplementedError(
            f"\n\tssl {mode} is not ported yet (ROADMAP Queue 1, item 4)\n\t"
            f"Supported modes: {sorted(supported_modes)}"
        )
    if mode not in supported_modes:
        raise NotImplementedError(
            f"\n\tMode {mode} not supported (yet)\n\t"
            f"Supported modes: {sorted(supported_modes)}"
        )
    importlib.import_module(supported_modes[mode]).main(arguments[1:])
